"""tools/stage_trace.py attributes each device kernel to the bounce stage
its op name carries (the named scopes of trace_paths / Scene.intersect)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import stage_trace  # noqa: E402


@pytest.mark.parametrize("op_name,stage", [
    ("jit(one_pass)/while/body/intersect/while/body/reduce_min", "intersect"),
    ("jit(one_pass)/while/body/intersect/instanced/while/body/dot_general",
     "instanced"),
    ("jit(one_pass)/while/body/occlude/instanced/reduce_or", "instanced"),
    ("jit(one_pass)/while/body/occlude/or", "occlude"),
    ("jit(one_pass)/while/body/dispatch_shade/switch/mul", "dispatch_shade"),
    ("jit(one_pass)/while/body/surface_interaction/gather", "surface_interaction"),
    ("jit(one_pass)/while/body/nee_light_sample/dot_general", "nee_light_sample"),
    ("jit(one_pass)/add_samples_aligned/add", "other"),
    ("", "other"),
])
def test_stage_of(op_name, stage):
    assert stage_trace.stage_of(op_name) == stage


# an excerpt of an optimized HLO module in the form Compiled.as_text() prints
HLO = '''HloModule jit_one_pass, is_scheduled=true

%fused_computation.1 (param_0.4: f32[64,8]) -> f32[64,8] {
  %param_0.4 = f32[64,8]{1,0} parameter(0)
  %sin.0 = f32[64,8]{1,0} sine(%param_0.4), metadata={op_name="jit(one_pass)/while/body/intersect/sin"}
  %mul.2 = f32[64,8]{1,0} multiply(%sin.0, %sin.0), metadata={op_name="jit(one_pass)/while/body/intersect/mul"}
  ROOT %exp.0 = f32[64,8]{1,0} exponential(%mul.2), metadata={op_name="jit(one_pass)/while/body/dispatch_shade/exp"}
}

%fused_computation.2 (param_0.1: f32[8]) -> f32[8] {
  %param_0.1 = f32[8]{0} parameter(0)
  ROOT %cos.2 = f32[8]{0} cosine(%param_0.1), metadata={op_name="jit(one_pass)/while/body/occlude/instanced/cos"}
}

ENTRY %main.5 (x.1: f32[64,8]) -> f32[8] {
  %x.1 = f32[64,8]{1,0} parameter(0), metadata={op_name="x"}
  %loop_exponential_fusion.3 = f32[64,8]{1,0} fusion(%x.1), kind=kLoop, calls=%fused_computation.1, metadata={op_name="jit(one_pass)/while/body/dispatch_shade/exp"}
  %input_reduce-fusion = f32[8]{0} fusion(%x.1), kind=kInput, calls=%fused_computation.2
  %copy.6 = f32[8]{0} copy(%input_reduce-fusion), metadata={op_name="jit(one_pass)/add_samples_aligned/copy"}
  ROOT %custom-call.1 = f32[8]{0} custom-call(%copy.6), custom_call_target="__cublas$gemm"
}
'''


@pytest.mark.parametrize("kernel,stage", [
    # two intersect ops outvote the fusion's own dispatch_shade root
    ("loop_exponential_fusion_3", "intersect"),
    # a fusion emitted as several kernels
    ("loop_exponential_fusion_3_1", "intersect"),
    # no metadata of its own: the fused body decides
    ("input_reduce_fusion", "instanced"),
    ("copy_6", "other"),
    ("custom_call_1", "other"),
    ("sm90_xmma_gemm_f32f32_f32", "unmatched"),
    ("jit(one_pass)/while/body/occlude/or", "occlude"),
])
def test_hlo_kernel_stage(kernel, stage):
    hlo_map = stage_trace.hlo_stage_map(HLO)
    assert stage_trace.stage_of_kernel([kernel], hlo_map) == stage


def test_hlo_stage_map_of_compiled_module():
    """The parser reads the module text this JAX version prints."""
    import jax
    import jax.numpy as jnp

    def f(x):
        with jax.named_scope("intersect"):
            a = jnp.sin(x) * 2.0
        with jax.named_scope("dispatch_shade"):
            b = jnp.exp(a).sum(0)

        def body(i, c):
            with jax.named_scope("occlude"):
                return c * 1.01 + jnp.cos(c)

        return jax.lax.fori_loop(0, 3, body, b)

    x = jnp.ones((64, 8))
    text = jax.jit(f).lower(x).compile().as_text()
    stages = set(stage_trace.hlo_stage_map(text).values())
    assert {"intersect", "dispatch_shade", "occlude", "other"} <= stages
