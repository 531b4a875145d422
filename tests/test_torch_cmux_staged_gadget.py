"""The plain CMux step at a 2^1 x 20 gadget (L > 16: the card's staged
route, kernel H), n = 32: the JAX ``cmux_stage1`` / ``cmux_stage2`` and
``fused_cmux_step`` (Pallas in interpret mode) against the port's
``cmux_stage1`` / ``cmux_stage2`` and the CPU ``CmuxStepPlan``
(``test_torch_cmux_staged.py``'s check, in a file of its own so that its
~40 s of tracing runs on another worker).  Tolerance: zero (bit-equal)."""

from primus_fhe_tpu_torch.ops import cmux_fused
from test_torch_cmux_staged import check_stages_and_step, staged_case


def test_gadget_2x20_stages_and_step_match_jax():
    case = staged_case(1, 1, 20, None)
    k, level, conv = case[:3]
    assert cmux_fused.step_route(conv.count, k + 1, level, conv.log_n) == "staged"
    check_stages_and_step(case)
