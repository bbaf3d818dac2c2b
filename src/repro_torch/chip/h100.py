"""One NVIDIA H100 read as an ICCA pod for the ELK planner (port only).

Counterpart of ``tpu_v5e_pod`` (``chip/config.py``) for the card the port
serves on, in the terms of the weight-streaming mode (``serve/stream.py``):

* the one "core" is the whole card, and its local store ("SRAM" in the
  planner's vocabulary) is the card's HBM, where the execute state of the
  layer weights lives;
* the off-chip store ("HBM" in the planner's vocabulary) is pinned host
  memory behind PCIe, where the preload state lives: the planner prices
  bringing a layer's weights onto the card at the PCIe rate;
* there are no peers: one core, so no inter-core traffic.  The planner
  still routes every preload over the core's link (at one core its
  delivery rate is ``min(link_bw, off-chip rate)``), and the one link a
  preload crosses on this card is the PCIe link itself: ``link_bw``
  defaults to the PCIe rate.  From there up the knobs do not depend on it;
  below it the link, not PCIe, would pace the preloads
  (``tests/test_torch_planner.py`` checks both).

Every constant is a datasheet number of the H100 SXM5 80GB (NVIDIA H100
Tensor Core GPU datasheet); ``PERF.md`` names them and gives beside them
the rates ``chip_smoke.py`` measured.  Units are bytes, bytes/s and FLOP/s,
decimal as the datasheet gives them.
"""

from __future__ import annotations

from repro_torch.chip.config import ChipConfig

HBM_BYTES = 80e9           # HBM3, 80 GB
HBM_BYTES_PER_S = 3.35e12  # HBM3, 3.35 TB/s
BF16_FLOPS = 989e12        # dense bf16 on the tensor cores (no sparsity)
FP32_FLOPS = 67e12         # fp32 outside the tensor cores
PCIE_BYTES_PER_S = 64e9    # PCIe Gen5 x16: 128 GB/s both ways, 64 GB/s host to card


def h100_host(link_bw: float = PCIE_BYTES_PER_S) -> ChipConfig:
    """One H100 with its weights' home in pinned host memory, as a one-core
    pod: HBM is the on-chip store, host memory over PCIe the off-chip one.
    ``link_bw`` is the one core's link, which preloads cross: PCIe."""
    return ChipConfig(
        name="h100-host",
        num_cores=1,
        sram_per_core=int(HBM_BYTES),
        core_flops=BF16_FLOPS,
        core_flops_vector=FP32_FLOPS,
        sram_bw_per_core=HBM_BYTES_PER_S,
        link_bw=link_bw,
        topology="all2all",
        hbm_bw=PCIE_BYTES_PER_S,
        hbm_controllers=1,          # one PCIe link
        sram_port_blocking=False,   # HBM is not blocked by host copies
        reserved_per_core=0,
    )
