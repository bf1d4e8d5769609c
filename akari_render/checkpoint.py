"""Render checkpoint / resume.

The reference has NO render-state checkpointing (SURVEY.md §5: intermediate
EXR dumps are restart artifacts, not resumable state) — this is a
deliberate addition: film + pass counter + (for MCMC) chain state round-trip
through a single .npz, so long renders survive preemption. Everything is
already flat arrays.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .core.film import Film

FORMAT_VERSION = 1


def save_checkpoint(path: str | Path, film: Film, meta: dict, extra: dict | None = None):
    """meta: JSON-serializable (spp done, config hash...); extra: named arrays."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {
        "accum": np.asarray(film.accum),
        "splat": np.asarray(film.splat),
        "weight": np.asarray(film.weight),
    }
    for k, v in (extra or {}).items():
        arrays[f"x_{k}"] = np.asarray(v)
    arrays["_meta"] = np.frombuffer(
        json.dumps({"version": FORMAT_VERSION, **meta}).encode(), np.uint8
    )
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, **arrays)
    tmp.replace(path)


def load_checkpoint(path: str | Path):
    """Returns (film, meta, extra) or None if absent/incompatible."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        z = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(z["_meta"]).decode())
        if meta.get("version") != FORMAT_VERSION:
            return None
        import jax.numpy as jnp

        film = Film(
            accum=jnp.asarray(z["accum"]),
            splat=jnp.asarray(z["splat"]),
            weight=jnp.asarray(z["weight"]),
        )
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
        return film, meta, extra
    except Exception:
        return None
