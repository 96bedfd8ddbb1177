"""The card's peak rates and the model-FLOPs-utilisation (MFU) math (port
of ``deepspeed_tpu/profiling/utilization.py``).

The ONE table that ``chip_smoke.py``, the flops profiler
(:meth:`~.flops_profiler.profiler.FlopsProfile.mfu`) and every receipt
quote, so utilisation numbers cannot drift between reporters.  The
figures are NVIDIA's data-sheet numbers for the H100 ("NVIDIA H100
Tensor Core GPU" data sheet: dense Tensor Core rates, i.e. without the
2:4 sparsity factor; HBM bandwidth; NVLink and PCIe Gen5 per direction),
keyed by substrings of ``torch.cuda.get_device_name``.  They are peaks a
card reaches at its full power limit; a card capped below it (the power
limit ``nvidia-smi`` reports) runs slower under load, so a measured MFU
stands beside that limit.
"""

import torch

# by lower-case device-name substring, the first match wins (the PCIe and
# NVL cards before the SXM card, whose name is "NVIDIA H100 80GB HBM3").
# TFLOP/s dense: bf16/fp16 Tensor Core, TF32 Tensor Core, fp32 CUDA core;
# GB/s: HBM, NVLink per direction, host link (PCIe Gen5 x16) per direction
CHIP_TABLE = (
    ("h100 pcie", {"peak_tflops": 756.0, "peak_tflops_tf32": 378.0,
                   "peak_tflops_fp32": 51.0, "hbm_gbps": 2000.0,
                   "link_gbps": 300.0, "host_gbps": 64.0}),
    ("h100 nvl", {"peak_tflops": 835.0, "peak_tflops_tf32": 417.0,
                  "peak_tflops_fp32": 60.0, "hbm_gbps": 3900.0,
                  "link_gbps": 300.0, "host_gbps": 64.0}),
    ("h100", {"peak_tflops": 989.0, "peak_tflops_tf32": 494.5,
              "peak_tflops_fp32": 67.0, "hbm_gbps": 3350.0,
              "link_gbps": 450.0, "host_gbps": 64.0}),
)
# the SXM card's row: the card this repo measures on
H100_SXM = dict(CHIP_TABLE[-1][1])

# bf16 peak TFLOP/s by name substring (the JAX module's PEAK_TFLOPS)
PEAK_TFLOPS = {key: row["peak_tflops"] for key, row in CHIP_TABLE}

# Unknown cards assume the fastest card of the table, so that an MFU
# above 1 (a harness that measured nothing) is never a false alarm on a
# legitimately fast card.
DEFAULT_PEAK_TFLOPS = H100_SXM["peak_tflops"]


def _name(device):
    """The device name of ``device``: a name string as it is, else
    ``torch.cuda.get_device_name`` of the CUDA device (index, string or
    ``torch.device``; None is the current one)."""
    if isinstance(device, str) and not device.startswith("cuda"):
        return device
    return torch.cuda.get_device_name(device)


def chip_specs(device_kind=""):
    """Roofline constants for one device name: ``{device_kind,
    peak_tflops, peak_tflops_tf32, peak_tflops_fp32, hbm_gbps, link_gbps,
    host_gbps}``.  An unknown name (the CPU included) gets the SXM
    card's figures."""
    kind = (device_kind or "").lower()
    row = H100_SXM
    for key, val in CHIP_TABLE:
        if key in kind:
            row = val
            break
    return dict(row, device_kind=device_kind or "")


def chip_peak_tflops(device=None, dtype=torch.bfloat16):
    """Peak dense TFLOP/s of ``device`` (a CUDA device or a device name)
    for operands of ``dtype``: the Tensor Core rate for bf16 and fp16,
    the fp32 CUDA-core rate for fp32 (the port runs fp32 with TF32 off)."""
    specs = chip_specs(_name(device))
    if dtype == torch.float32:
        return specs["peak_tflops_fp32"]
    return specs["peak_tflops"]


def achieved_tflops(samples_per_sec, flops_per_sample):
    """Model TFLOP/s actually sustained."""
    return samples_per_sec * flops_per_sample / 1e12


def model_flops_utilization(samples_per_sec, flops_per_sample,
                            peak_tflops):
    """MFU in [0, 1] (values > 1 mean the harness measured nothing —
    callers hard-fail on that)."""
    return achieved_tflops(samples_per_sec, flops_per_sample) / peak_tflops
