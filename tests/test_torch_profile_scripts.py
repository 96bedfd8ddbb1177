"""The kernel-family rule of ``examples/profile_torch_train.py``, which
splits a profiled step's device time by kernel: in the sparse GPT-2
step (G = 1) the super-tile kernels' time is B5a's and B5b's, in the
sparse BERT step (G = 4) B6's, and the bf16 B3 counts as B3; and the
short names ``op_builder.kernel_name`` gives the mangled kernels of a
ptxas report, which the profiling scripts print."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import profile_torch_train as ptt  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

AGG_FWD = "void (anonymous namespace)::agg_fwd_mma_kernel<64>(bf16 const*)"
AGG_DQ = "void (anonymous namespace)::agg_bwd_dq_mma_kernel<64>(bf16 const*)"
AGG_DKV = "void (anonymous namespace)::agg_bwd_dkv_mma_kernel<64>(bf16*)"


@pytest.mark.parametrize("name,mode,family", [
    (AGG_FWD, "sparse", "B5a sparse flash forward"),
    (AGG_DQ, "sparse", "B5b sparse flash dq"),
    (AGG_DKV, "sparse", "B5b sparse flash dk/dv"),
    ("void fbs_fwd_kernel<float, 64>(float const*)", "sparse",
     "B5a sparse flash forward"),
    (AGG_FWD, "bert-sparse", "B6a super-tile forward"),
    (AGG_DQ, "bert-sparse", "B6b super-tile dq"),
    (AGG_DKV, "bert-sparse", "B6c super-tile dk/dv"),
    ("void flash_bwd_fused_mma_kernel<64>(bf16 const*)", "bert",
     "B3 flash fused backward"),
    ("void flash_bwd_dq_mma_kernel<64>(bf16 const*)", "bert",
     "B2a flash dq"),
    ("void at::native::vectorized_elementwise_kernel<4>()", "bert",
     "other"),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL(ncclDevKernelArgs)",
     "gpt2", "NCCL collectives")])
def test_family_counts_each_kernel_where_the_step_runs_it(name, mode,
                                                          family):
    assert ptt.family(name, mode) == family


def test_every_mode_names_the_libraries_of_its_attention():
    assert set(ptt.LIBRARIES) == set(ptt.SETUPS)
    for libs in ptt.LIBRARIES.values():
        assert set(libs) <= set(ptt.op_builder.SOURCES)


@pytest.mark.parametrize("mangled,name", [
    ("_ZN35_INTERNAL_fd45b911_25_flash_block_sparse_agg_cu_c3f70b7622"
     "agg_bwd_dkv_mma_kernelILi64EEEvPK13__nv_bfloat16",
     "agg_bwd_dkv_mma_kernel_d64"),
    ("_ZN35_INTERNAL_d09a935d_22_flash_attention_bwd_cu_a6d4ba1f26"
     "flash_bwd_fused_mma_kernelILi64ELi4EEEvPK13__nv_bfloat16",
     "flash_bwd_fused_mma_kernel_d64_w4"),
    ("_ZN35_INTERNAL_d09a935d_22_flash_attention_bwd_cu_a6d4ba1f22"
     "flash_bwd_fused_kernelIfLi128EEEvPKT_",
     "flash_bwd_fused_kernel_fp32_d128"),
    ("_ZN35_INTERNAL_b0bd14b_22_flash_attention_fwd_cu_ba3050c620"
     "flash_fwd_mma_kernelILi64ELb1EEEvPK13__nv_bfloat16",
     "flash_fwd_mma_kernel_d64_dropout"),
    ("_ZN35_INTERNAL_e_18_flash_block_sparse_cu_f14"
     "fbs_fwd_kernelIfLi64EEEvPKT_", "fbs_fwd_kernel_fp32_d64"),
    # the fp16 instantiation of a tensor-core kernel template, beside its
    # bf16 one (which keeps the name it had before the element type
    # became a template argument)
    ("_ZN35_INTERNAL_d09a935d_22_flash_attention_bwd_cu_a6d4ba1f26"
     "flash_bwd_fused_mma_kernelI6__halfLi64ELi8EEEvPKT_",
     "flash_bwd_fused_mma_kernel_fp16_d64_w8"),
    ("_ZN35_INTERNAL_b0bd14b_22_flash_attention_fwd_cu_ba3050c620"
     "flash_fwd_mma_kernelI13__nv_bfloat16Li64ELb1EEEvPKT_",
     "flash_fwd_mma_kernel_d64_dropout")])
def test_kernel_name_keeps_the_kernels_own_name(mangled, name):
    assert op_builder.kernel_name(mangled) == name


@pytest.mark.parametrize("name,family", [
    ("Memcpy HtoD (Pinned -> Device)", "H2D copies"),
    ("Memcpy DtoH (Device -> Pinned)", "D2H copies"),
    ("void at::native::vectorized_elementwise_kernel<4>()", "other")])
def test_the_offload_step_counts_its_copies_apart(name, family):
    assert ptt.family(name, "offload") == family


def test_copy_overlap_is_measured_on_the_union_of_spans():
    """Copies 0-10 and 5-20 (union 20), kernels 15-30 and 40-50: 5 us
    of copy beside a kernel, 40 us with either running."""
    events = [("Memcpy HtoD (Pinned -> Device)", 0, 10),
              ("Memcpy DtoH (Device -> Pinned)", 5, 20),
              ("flash_fwd_mma_kernel", 15, 30), ("gemm", 40, 50)]
    assert ptt.copy_overlap(events) == (20, 5, 40)
