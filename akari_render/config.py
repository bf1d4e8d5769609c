"""Render task configuration: the reference's method JSON schema.

Reference: crates/akari_integrator/src/lib.rs:57-109 (`Method` tagged enum,
`RenderTask`), pt.rs:916-944 (PT defaults), mcmc.rs:43-78, gpt.rs:32-65.
The same method.json files (e.g. scenes/cbox/pt.json) parse unchanged.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class PTConfig:
    spp: int = 256
    max_depth: int = 7
    spp_per_pass: int = 64
    use_nee: bool = True
    rr_depth: int = 5
    indirect_only: bool = False
    force_diffuse: bool = False
    pixel_offset: tuple = (0, 0)
    clamp_indirect: float = 1000.0
    color: str = "rgb"  # FilmColorRepr (lib.rs:81-88): "rgb" | "spectral"

    @staticmethod
    def from_json(d: dict) -> "PTConfig":
        return PTConfig(
            spp=d.get("spp", 256),
            max_depth=d.get("max_depth", 7),
            spp_per_pass=d.get("spp_per_pass", 64),
            use_nee=d.get("use_nee", True),
            rr_depth=d.get("rr_depth", 5),
            indirect_only=d.get("indirect_only", False),
            force_diffuse=d.get("force_diffuse", False),
            pixel_offset=tuple(d.get("pixel_offset", (0, 0))),
            clamp_indirect=d.get("clamp_indirect", 1000.0),
            color=_parse_color(d.get("color", "rgb")),
        )


def _parse_color(c) -> str:
    """ColorRepr config (color.rs:81-93): "spectral" or {"type": "spectral"}
    select hero-wavelength transport; anything rgb-flavored maps to "rgb"."""
    if isinstance(c, dict):
        c = c.get("type", "rgb")
    c = str(c).lower()
    return "spectral" if c == "spectral" else "rgb"


@dataclass
class MCMCConfig:
    """Kelemen PSSMLT (ref mcmc.rs:43-78 defaults, mcmc_opt.rs)."""

    spp: int = 256
    max_depth: int = 7
    rr_depth: int = 5
    spp_per_pass: int = 64
    use_nee: bool = True
    n_chains: int = 512
    n_bootstrap: int = 100_000
    mcmc_depth: int | None = None
    exponential_mutation: bool = True
    small_sigma: float = 0.01
    large_step_prob: float = 0.1
    image_mutation_size: float | None = None
    image_mutation_prob: float = 0.0
    direct_spp: int = 64

    @staticmethod
    def from_json(d: dict) -> "MCMCConfig":
        return MCMCConfig(
            spp=d.get("spp", 256),
            max_depth=d.get("max_depth", 7),
            rr_depth=d.get("rr_depth", 5),
            spp_per_pass=d.get("spp_per_pass", 64),
            use_nee=d.get("use_nee", True),
            n_chains=d.get("n_chains", 512),
            n_bootstrap=d.get("n_bootstrap", 100_000),
            mcmc_depth=d.get("mcmc_depth"),
            exponential_mutation=d.get("exponential_mutation", True),
            small_sigma=d.get("small_sigma", 0.01),
            large_step_prob=d.get("large_step_prob", 0.1),
            image_mutation_size=d.get("image_mutation_size"),
            image_mutation_prob=d.get("image_mutation_prob", 0.0),
            direct_spp=d.get("direct_spp", 64),
        )


@dataclass
class GPTConfig:
    """Gradient-domain PT (ref gpt.rs:32-65)."""

    spp: int = 256
    max_depth: int = 7
    rr_depth: int = 5
    spp_per_pass: int = 64
    use_nee: bool = True
    reconstruction_iter: int = 30
    shift_mapping_min_dist: float = 0.03
    shift_mapping_min_roughness: float = 0.2
    stride: int = 1
    # uniform-weight Jacobi (the reference's Reconstruction::Uniform; its
    # DEFAULT is no reconstruction at all, gpt.rs:27-31). False selects the
    # reference-exact Weighted mode: inverse-variance neighbor weights +
    # the per-iteration primal-weight prefix schedule (gpt.rs:505-514).
    uniform_weights: bool = True
    # the reference's `reconnect: bool` (gpt.rs:42, default true). None =
    # use render_gpt's default (reconnect, reference parity); an explicit
    # method-JSON value wins.
    reconnect: bool | None = None
    # the reference's `separate_weights` (gpt.rs:44, default false there):
    # pair the camera-vertex contributions (jacobian-1 PSS shifts) at
    # weight 1/2 and only the rest under the reconnection-jacobian MIS
    # (gpt.rs:192-204, 290-331). DEFAULT TRUE here — a documented measured
    # deviation: with the lumped weighting the reconnection shift LOSES to
    # plain pss replay on every fixture (the r3/r4 record); with separate
    # weights it wins the diffuse-receiver fixtures (round-5 re-measure).
    separate_weights: bool = True

    @staticmethod
    def from_json(d: dict) -> "GPTConfig":
        return GPTConfig(
            spp=d.get("spp", 256),
            max_depth=d.get("max_depth", 7),
            rr_depth=d.get("rr_depth", 5),
            spp_per_pass=d.get("spp_per_pass", 64),
            use_nee=d.get("use_nee", True),
            reconstruction_iter=d.get("reconstruction_iter", 30),
            shift_mapping_min_dist=d.get("shift_mapping_min_dist", 0.03),
            shift_mapping_min_roughness=d.get("shift_mapping_min_roughness", 0.2),
            stride=d.get("stride", 1),
            uniform_weights=d.get("uniform_weights", True),
            reconnect=d.get("reconnect"),
            separate_weights=d.get("separate_weights", True),
        )


@dataclass
class AOVConfig:
    spp: int = 32

    @staticmethod
    def from_json(d: dict) -> "AOVConfig":
        return AOVConfig(spp=d.get("spp", 32))


_METHODS = {"pt": PTConfig, "mcmc": MCMCConfig, "mcmc_opt": MCMCConfig, "gpt": GPTConfig, "aov": AOVConfig}


@dataclass
class RenderTask:
    method_type: str
    method: object
    sampler: dict = field(default_factory=lambda: {"type": "independent", "seed": 0})
    film: dict = field(default_factory=dict)

    @property
    def out_path(self) -> str:
        return self.film.get("out", "out.exr")

    @property
    def filter_config(self) -> dict | None:
        return self.film.get("filter")

    @property
    def seed(self) -> int:
        return int(self.sampler.get("seed", 0))

    @staticmethod
    def from_json(d: dict) -> "RenderTask":
        m = d["method"]
        t = m["type"]
        cls = _METHODS[t]
        return RenderTask(
            method_type=t,
            method=cls.from_json(m),
            sampler=d.get("sampler", {"type": "independent", "seed": 0}),
            film=d.get("film", {}),
        )

    @staticmethod
    def from_file(path: str | Path) -> "RenderTask":
        return RenderTask.from_json(json.loads(Path(path).read_text()))

    @staticmethod
    def list_from_file(path: str | Path) -> list["RenderTask"]:
        """RenderTask::{Single,Multi} (ref lib.rs:103-109, untagged): a
        method file holding a JSON LIST renders each config in sequence."""
        doc = json.loads(Path(path).read_text())
        if isinstance(doc, list):
            return [RenderTask.from_json(d) for d in doc]
        return [RenderTask.from_json(doc)]
