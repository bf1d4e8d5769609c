"""Control for phase 4 of chip_smoke.py: do its GPU-vs-CPU limits catch
contractions that run in TF32?

Runs phase 4's comparisons (cbox 64^2 16 spp and classroom 96x54 1 spp,
the same seeded PT pass rendered twice) with the instance transforms,
albedo-table contractions and colour transforms faulted in one of the two
renders:

  default   (GPU only) the first render asks for JAX's default precision
            instead of HIGHEST at those sites: TF32 wherever XLA sends the
            contraction to a TF32 matmul; the second runs on the CPU
            backend, as in phase 4.
  --emulate the first render rounds the sites' f32 operands to TF32's 10
            mantissa bits (what a TF32 matmul does to its inputs); the
            second is the sound render. Any backend.

Prints each gap and the limits it breaks. Exits 0 when the control breaks
at least one limit (phase 4 would catch the fault) and 1 when it breaks
none.

    python tools/precision_control.py [--emulate]
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import itertools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# modules whose f32 contractions take `precision=HIGHEST` from a module global
SITES = ("akari_render.accel.instanced", "akari_render.svm.precompute",
         "akari_render.core.color", "akari_render.core.spectral")


@contextlib.contextmanager
def _patched(attr: str, value_of):
    mods = [importlib.import_module(m) for m in SITES]
    saved = [getattr(m, attr) for m in mods]
    for m in mods:
        setattr(m, attr, value_of(getattr(m, attr)))
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            setattr(m, attr, s)


def default_precision_sites():
    """Trace the SITES' contractions at the default precision."""
    import jax

    return _patched("HIGHEST", lambda _: jax.lax.Precision.DEFAULT)


class _Tf32Numpy:
    """jax.numpy, with the operands of einsum / matmul rounded to TF32."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def _tf32(self, x):
        import jax

        x = self._jnp.asarray(x)
        if x.dtype != self._jnp.float32:
            return x
        return jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=10)

    def einsum(self, spec, *ops, **kw):
        return self._jnp.einsum(spec, *map(self._tf32, ops), **kw)

    def matmul(self, a, b, **kw):
        return self._jnp.matmul(self._tf32(a), self._tf32(b), **kw)


def tf32_operands():
    """Round the f32 operands of the SITES' contractions to TF32."""
    return _patched("jnp", _Tf32Numpy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--emulate", action="store_true",
                    help="fault the first render by rounding operands to TF32")
    args = ap.parse_args(argv)

    import bench
    import chip_smoke

    if args.emulate:
        # reference_gaps renders the faulted image first, then the sound one
        calls = itertools.count()
        render = chip_smoke._render_on

        def faulted_first(*a):
            ctx = tf32_operands() if next(calls) % 2 == 0 else contextlib.nullcontext()
            with ctx:
                return render(*a)

        chip_smoke._render_on = faulted_first
        fault = contextlib.nullcontext()
        print("control: operands rounded to TF32 in the first render", flush=True)
    else:
        dev = bench.require_gpu()
        print(f"card: {dev['card']}", flush=True)
        fault = default_precision_sites()
    fails = []
    with fault:
        for job in chip_smoke.REFERENCE_JOBS:
            fails += chip_smoke.reference_failures(
                job[0], chip_smoke.reference_gaps(*job))
    for f in fails:
        print(f"control breaks: {f}", flush=True)
    if not fails:
        print("control breaks no limit: phase 4 would not catch it", flush=True)
    return 0 if fails else 1


if __name__ == "__main__":
    sys.exit(main())
