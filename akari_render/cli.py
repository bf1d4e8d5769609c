"""Command-line renderer: the akari-cli equivalent.

Reference: crates/akari_api/src/bin/akari_cli.rs — args `-s scene.json -m
method.json` (+ verbosity / save-intermediate / save-stats). Same flags here
plus overrides for quick tests (--res, --spp) and multi-device sharding
(--devices).

Usage:
    python -m akari_render.cli -s scenes/cbox/scene.json -m scenes/cbox/pt.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="akari")
    ap.add_argument("-s", "--scene", required=True, help="scene.json path")
    ap.add_argument("-m", "--method", required=True, help="method json path")
    ap.add_argument("-o", "--output", default=None, help="override output image path")
    ap.add_argument("--spp", type=int, default=None, help="override spp")
    ap.add_argument("--res", type=int, default=None, help="override square resolution")
    ap.add_argument("--save-stats", action="store_true")
    ap.add_argument("--save-intermediate", action="store_true")
    ap.add_argument("--checkpoint", default=None, help="checkpoint file for resume")
    ap.add_argument("--checkpoint-every", type=int, default=16, help="passes between checkpoints")
    ap.add_argument(
        "--devices", type=int, default=1,
        help="shard the render over N devices (pt/mcmc/gpt; 1 = single-chip)",
    )
    ap.add_argument(
        "--gui", action="store_true",
        help="serve a live progressive preview over local HTTP (akari --gui analog)",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument(
        "--cpu", action="store_true",
        help="pin to host CPU (AKR_FORCE_CPU=1 works too)",
    )
    args = ap.parse_args(argv)

    import os

    if args.cpu or os.environ.get("AKR_FORCE_CPU"):
        import jax

        jax.config.update("jax_platforms", "cpu")

    from .config import RenderTask
    from .core.image_io import write_image
    from .scene import load_scene

    # RenderTask::{Single,Multi} (ref lib.rs:103-109): a list renders each
    # config in sequence against the same loaded scene
    tasks = RenderTask.list_from_file(args.method)
    for task in tasks:
        if args.spp is not None:
            task.method.spp = args.spp

    t0 = time.time()
    scene = load_scene(args.scene, width=args.res, height=args.res)
    print(
        f"loaded scene: {scene.num_tris} tris, {len(scene.kinds)} shader kinds, "
        f"{scene.arrays.lights.num_lights} lights, "
        f"{scene.camera.width}x{scene.camera.height} ({time.time()-t0:.2f}s)",
        file=sys.stderr,
    )

    def progress(p, total, stats):
        # pt reports samples done / total spp; mcmc/gpt report pass counts
        print(f"  {p}/{total}  t={stats['time'][-1]:.2f}s", file=sys.stderr)

    from .stats import RenderSession

    for task_idx, task in enumerate(tasks):
        _render_one(task, task_idx, len(tasks), scene, args, progress_cb=progress if args.verbose else None)


def _render_one(task, task_idx, n_tasks, scene, args, progress_cb):
    import json

    from .core.image_io import write_image
    from .stats import RenderSession

    out_p = Path(args.output or task.out_path)
    if n_tasks > 1:
        # Multi: -o override becomes a per-task suffixed path
        if args.output:
            out_p = out_p.with_name(f"{out_p.stem}_{task_idx}{out_p.suffix}")
    session = RenderSession(
        name=out_p.stem,
        save_intermediate=args.save_intermediate,
        save_stats=args.save_stats,
        out_dir=str(out_p.parent),
    )
    if args.gui:
        from .gui import DisplayServer

        server = DisplayServer()
        session.display = server.update
        print(f"progressive preview: {server.url}", file=sys.stderr)

    mesh = None
    if args.devices > 1:
        from .parallel.shard import make_mesh

        mesh = make_mesh(args.devices)

    if task.method_type == "pt":
        if mesh is not None:
            from .parallel.shard import render_pt_sharded

            img, stats = render_pt_sharded(
                scene, task.method, task, mesh=mesh,
                progress_cb=progress_cb,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                session=session,
            )
        else:
            from .integrators.pt import render_pt

            img, stats = render_pt(
                scene, task.method, task,
                progress_cb=progress_cb,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                session=session,
            )
    elif task.method_type in ("mcmc", "mcmc_opt"):
        if mesh is not None:
            from .parallel.shard import render_mcmc_sharded

            img, stats = render_mcmc_sharded(
                scene, task.method, task, mesh=mesh,
                progress_cb=progress_cb, session=session,
            )
        else:
            from .integrators.mcmc import render_mcmc

            img, stats = render_mcmc(
                scene, task.method, task, progress_cb=progress_cb, session=session,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
            )
    elif task.method_type == "gpt":
        if mesh is not None:
            from .parallel.shard import render_gpt_sharded

            img, stats = render_gpt_sharded(
                scene, task.method, task, mesh=mesh,
                progress_cb=progress_cb, session=session,
            )
        else:
            from .integrators.gpt import render_gpt

            img, stats = render_gpt(
                scene, task.method, task, progress_cb=progress_cb, session=session,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
            )
    elif task.method_type == "aov":
        from .integrators.aov import render_aov

        img, stats = render_aov(scene, task.method, task)
        base = Path(args.output or task.out_path)
        for name, im in stats.pop("images").items():
            p = base.with_name(f"{base.stem}_{name}{base.suffix}")
            write_image(p, im)
            print(f"wrote {p}", file=sys.stderr)
    else:
        raise SystemExit(f"unknown method: {task.method_type}")

    out = str(out_p)
    write_image(out, img)
    print(f"wrote {out}  ({stats.get('total_time', 0.0):.2f}s render)", file=sys.stderr)
    if args.save_stats:
        stats_path = Path(out).with_suffix(".stats.json")
        scalars = {
            k: v for k, v in stats.items()
            if not hasattr(v, "shape") or getattr(v, "ndim", 0) <= 1
        }
        stats_path.write_text(json.dumps(scalars, default=float))
        print(f"wrote {stats_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
