"""MSE-vs-spp/time benchmark per the BASELINE.md protocol.

Renders a high-spp ground truth with the PT integrator, then measures
per-pixel MSE at increasing spp for each integrator (pt / mcmc / gpt),
emitting the reference's stats-JSON format ({time, spp, path} series +
mse) so MSE-vs-time curves are directly comparable with the Rust renderer
if it is ever run on the same scenes.

    python tools/benchmark_mse.py --scene scenes/cbox/scene.json \
        --res 256 --gt-spp 4096 --out bench_mse.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    # AKR_FORCE_CPU=1 pins the run to host CPU
    if os.environ.get("AKR_FORCE_CPU"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--scene",
        default=str(Path(__file__).resolve().parent.parent / "scenes/cbox/scene.json"),
    )
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--gt-spp", type=int, default=4096)
    ap.add_argument("--max-depth", type=int, default=7)
    ap.add_argument("--spp", type=int, nargs="+", default=[4, 16, 64, 256])
    ap.add_argument("--out", default="bench_mse.json")
    ap.add_argument("--methods", nargs="+", default=["pt", "gpt", "mcmc"])
    ap.add_argument(
        "--gt-exr", default=None,
        help="reuse a previously-rendered ground truth EXR instead of "
             "re-rendering it (e.g. the .gt.exr a prior run saved); the "
             "file must match --res and come from the same scene",
    )
    ap.add_argument(
        "--merge-into", default=None,
        help="read an existing results JSON and merge the new method "
             "series into it (for filling in one method after a partial "
             "run) before writing --out",
    )
    ap.add_argument(
        "--gpt-min-roughness", type=float, default=0.2,
        help="reconnection roughness criterion: a vertex pair reconnects "
             "only when BOTH endpoint roughnesses are >= this, so LOWER it "
             "(e.g. 0.1) on glossy scenes or almost no vertex qualifies and "
             "the shift degenerates to discarded half-vector replays",
    )
    args = ap.parse_args()

    import numpy as np

    from akari_render.config import GPTConfig, MCMCConfig, PTConfig
    from akari_render.core.image_io import write_image
    from akari_render.integrators.gpt import render_gpt
    from akari_render.integrators.mcmc import render_mcmc
    from akari_render.integrators.pt import render_pt
    from akari_render.scene import load_scene

    scene = load_scene(args.scene, width=args.res, height=args.res)
    if args.gt_exr:
        from akari_render.core.image_io import read_exr

        gt = read_exr(args.gt_exr)
        assert gt.shape[0] == args.res and gt.shape[1] == args.res, gt.shape
        print(f"ground truth: reused {args.gt_exr}", file=sys.stderr)
    else:
        print(f"ground truth: pt {args.gt_spp} spp...", file=sys.stderr)
        t0 = time.time()
        gt, _ = render_pt(
            scene, PTConfig(spp=args.gt_spp, max_depth=args.max_depth, spp_per_pass=64)
        )
        print(f"  done in {time.time()-t0:.1f}s", file=sys.stderr)
        write_image(Path(args.out).with_suffix(".gt.exr"), gt)

    def mse(img):
        return float(np.mean((img - gt) ** 2))

    results = {"scene": args.scene, "res": args.res, "gt_spp": args.gt_spp, "series": {}}
    if args.merge_into and Path(args.merge_into).exists():
        prior = json.loads(Path(args.merge_into).read_text())
        for k, v in prior.items():  # keep platform/note/... metadata
            if k != "series":
                results.setdefault(k, v)
        results["series"].update(prior.get("series", {}))
    for method in args.methods:
        series = []
        for spp in args.spp:
            t0 = time.time()
            if method == "pt":
                img, _ = render_pt(
                    scene,
                    PTConfig(spp=spp, max_depth=args.max_depth, spp_per_pass=min(spp, 64)),
                )
            elif method in ("gpt", "gpt_pss"):
                img, _ = render_gpt(
                    scene,
                    GPTConfig(
                        spp=max(1, spp // 5), max_depth=args.max_depth,
                        shift_mapping_min_roughness=args.gpt_min_roughness,
                    ),
                    shift_mode="pss" if method == "gpt_pss" else "reconnect",
                )  # 5 paths per sample: equal ray budget
            elif method == "mcmc":
                img, _ = render_mcmc(
                    scene,
                    MCMCConfig(
                        spp=spp, max_depth=args.max_depth,
                        n_chains=4096, n_bootstrap=65536,
                        direct_spp=min(spp, 16), spp_per_pass=min(spp, 64),
                    ),
                )
            dt = time.time() - t0
            e = mse(img)
            series.append({"time": dt, "spp": spp, "mse": e, "path": ""})
            print(f"{method:>5} spp={spp:<5} mse={e:.3e}  {dt:.1f}s", file=sys.stderr)
        results["series"][method] = series
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
