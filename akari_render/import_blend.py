"""`akari-import` equivalent: spawn Blender to export a .blend file.

Reference: crates/akari_scenegraph/src/bin/import.rs:31-91 — finds Blender
(BLENDER_PATH env or PATH), runs `blender -b file.blend -P exporter.py`.

    python -m akari_render.import_blend -i scene.blend -o out_dir
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path


def find_blender() -> str:
    env = os.environ.get("BLENDER_PATH")
    if env:
        return env
    exe = shutil.which("blender")
    if exe:
        return exe
    raise SystemExit(
        "Blender not found: set BLENDER_PATH or add `blender` to PATH "
        "(import.rs:7 uses the same convention)"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="akari-import")
    ap.add_argument("-i", "--input", required=True, help=".blend file")
    ap.add_argument("-o", "--output", required=True, help="output scene dir")
    args = ap.parse_args(argv)

    exporter = Path(__file__).resolve().parent.parent / "tools" / "blender_exporter.py"
    env = dict(os.environ)
    env["AKARI_RENDER_ROOT"] = str(exporter.parent.parent)
    cmd = [
        find_blender(), "-b", args.input, "-P", str(exporter), "--", "-o", args.output,
    ]
    print("+", " ".join(cmd), file=sys.stderr)
    raise SystemExit(subprocess.call(cmd, env=env))


if __name__ == "__main__":
    main()
