"""Port of the train step for the rwkv, hybrid and encdec families: one
step of ``reduced_config`` of rwkv6-7b and zamba2-2.7b on float32 weights
and of whisper-large-v3 on bf16 weights against the reference's jitted
``make_train_step`` (``tests/torch_train.py`` states the cases and
tolerances). On the CPU the recurrences take their plain versions, which
autograd differentiates, as the reference's CPU route takes its jnp
forms; on the card their CUDA kernels refuse inputs that require grad
(``chip_smoke.py``'s train leg (d) checks that).
"""
import pytest
import torch

from torch_parity import isolated_plan_caches
from torch_train import check_step, port_step, reference_step

torch.set_num_threads(1)

STEP_CASES = [("rwkv6_7b", "float32"), ("zamba2_2p7b", "float32"),
              ("whisper_large_v3", "bfloat16")]


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.mark.parametrize("arch,dtype", STEP_CASES)
def test_one_train_step_matches_the_reference(arch, dtype):
    ref = reference_step({}, arch, dtype)
    params, out = port_step(arch, ref)
    check_step(ref, params, out, dtype)
