"""Per-stage device time of one PT pass, from a jax.profiler trace (GPU).

Renders classroom (or --scene) at a resolution that fits one pixel block,
1 spp, depth 12, split pass off, so the whole pass is one compiled program;
traces one warm pass and sums the device kernel time by bounce stage: the
jax.named_scope labels of integrators/common.py::trace_paths and
Scene.intersect (intersect, instanced, occlude, surface_interaction,
nee_light_sample, dispatch_shade).

A GPU kernel is named after the HLO instruction it runs (`loop_fusion.12`
runs as `loop_fusion_12`). The tool maps each kernel name to that
instruction in the program's optimized HLO, and the instruction to the
stage that most of its fused ops' `op_name` metadata carry; kernels inside
`instanced` count there wherever they are called from. Rows: each stage;
`other` (a matched kernel outside every stage, e.g. camera rays or the
film); `unmatched` (no instruction of that name, e.g. library kernels).
Also prints the device busy time and idle share of the traced window, and
the largest unmatched kernels.

    python tools/stage_trace.py [--scene scenes/classroom/scene.json]
                                [--res 512x288] [--out DIR]
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAGES = ("instanced", "occlude", "intersect", "surface_interaction",
          "nee_light_sample", "dispatch_shade")

_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_CALLS = re.compile(r"\bcalls=%?([\w.\-]+)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def stage_of(op_name: str) -> str:
    parts = op_name.split("/")
    for s in STAGES:  # instanced first: it nests inside intersect/occlude
        if s in parts:
            return s
    return "other"


def kernel_key(name: str) -> str:
    """An HLO instruction name as its GPU kernel is named."""
    return re.sub(r"[.\-]", "_", name)


def hlo_stage_map(hlo_text: str) -> dict:
    """{kernel name: stage} for every instruction of an HLO module's text.

    An instruction's stage is the most common stage among the op_names of
    the computation it `calls=` (a fusion's body), else its own op_name's,
    counting only ops that carry a stage; `other` when none does."""
    comps: dict = {}
    instrs = []  # (name, own op_name or None, called computation or None)
    cur = None
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m and cur is not None:
            op = _OP_NAME.search(line)
            call = _CALLS.search(line)
            comps[cur].append(op.group(1) if op else None)
            instrs.append((m.group(1), op.group(1) if op else None,
                           call.group(1) if call else None))
            continue
        m = _COMP.match(line)
        if m:
            cur = m.group(1)
            comps[cur] = []
        elif line.strip() == "}":
            cur = None
    out = {}
    for name, op, call in instrs:
        votes = collections.Counter()
        for ops in (comps.get(call, ()), [op]):  # the fused body, else its own
            votes.update(stage_of(o) for o in ops if o)
            votes.pop("other", None)
            if votes:
                break
        out[kernel_key(name)] = votes.most_common(1)[0][0] if votes else "other"
    return out


def stage_of_kernel(names, hlo_map: dict) -> str:
    """Stage of a device event from its candidate names (kernel name, then
    its string stats): an op_name path that names a stage, else the HLO
    instruction the kernel runs; `unmatched` when neither is found."""
    for n in names:
        if "/" in n and stage_of(n) != "other":
            return stage_of(n)
    for n in names:
        key = kernel_key(n)
        while key:
            if key in hlo_map:
                return hlo_map[key]
            # a fusion emitted as several kernels adds a `_<i>` suffix
            head, sep, tail = key.rpartition("_")
            key = head if sep and tail.isdigit() else ""
    return "unmatched"


def reduce_trace(trace_dir: Path, hlo_map: dict) -> dict:
    """{'window_ns', 'busy_ns', 'stages': {stage: ns},
    'unmatched': {kernel: ns}} of the device planes."""
    from jax.profiler import ProfileData

    path = next(trace_dir.rglob("*.xplane.pb"))
    pd = ProfileData.from_file(str(path))
    stages: collections.Counter = collections.Counter()
    unmatched: collections.Counter = collections.Counter()
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                names = [ev.name] + [v for _, v in ev.stats if isinstance(v, str)]
                st = stage_of_kernel(names, hlo_map)
                stages[st] += ev.duration_ns
                if st == "unmatched":
                    unmatched[ev.name] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise SystemExit("no device events in the trace")
    spans.sort()
    busy, (lo, hi) = 0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return {"window_ns": spans[-1][1] - spans[0][0], "busy_ns": busy,
            "stages": dict(stages), "unmatched": dict(unmatched)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default=str(ROOT / "scenes/classroom/scene.json"))
    ap.add_argument("--res", default="512x288")
    ap.add_argument("--out", default=str(ROOT / ".cache" / "stage_trace"))
    args = ap.parse_args(argv)
    os.environ["AKR_SPLIT_DEPTH"] = "0"

    import jax
    import jax.numpy as jnp

    from akari_render.core.film import Film
    from akari_render.core.filters import GaussianFilter
    from akari_render.integrators.common import PTSettings
    from akari_render.integrators.pt import _render_pass_fn
    from akari_render.scene import load_scene

    w, h = (int(x) for x in args.res.split("x"))
    scene = load_scene(args.scene, width=w, height=h)
    fn = _render_pass_fn(scene, PTSettings(max_depth=12, rr_depth=5),
                         GaussianFilter(1.5), w, h, 1)
    if getattr(fn, "n_blocks", 1) != 1:
        raise SystemExit(f"{w}x{h} needs {fn.n_blocks} pixel blocks; lower --res")
    compiled = fn.lower(scene.arrays, Film.new(w, h), jnp.uint32(0)).compile()
    hlo_map = hlo_stage_map(compiled.as_text())
    jax.block_until_ready(compiled(scene.arrays, Film.new(w, h), jnp.uint32(0)))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(scene.arrays, Film.new(w, h), jnp.uint32(1)))
    untraced = time.perf_counter() - t0
    out = Path(args.out)
    with jax.profiler.trace(str(out)):
        jax.block_until_ready(compiled(scene.arrays, Film.new(w, h), jnp.uint32(2)))
    r = reduce_trace(out, hlo_map)
    total = sum(r["stages"].values())
    print(f"{jax.devices()[0].device_kind}: {Path(args.scene).parent.name} "
          f"{w}x{h} 1 spp, untraced pass {untraced:.4f} s; traced window "
          f"{r['window_ns'] / 1e6:.2f} ms, device busy {r['busy_ns'] / 1e6:.2f} ms, "
          f"idle share {1 - r['busy_ns'] / r['window_ns']:.3f}; "
          f"{len(hlo_map)} HLO instructions mapped")
    for k, v in sorted(r["stages"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:20s} {v / 1e6:9.3f} ms  {v / total:6.1%}")
    for k, v in sorted(r["unmatched"].items(), key=lambda kv: -kv[1])[:10]:
        print(f"  unmatched kernel {v / 1e6:9.3f} ms  {k[:100]}")


if __name__ == "__main__":
    main()
