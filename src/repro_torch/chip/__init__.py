from repro_torch.chip.config import ChipConfig, ipu_mk2, ipu_pod4_hbm, tpu_v5e_pod, tpu_v5e_pod_hier, tpu_v5e_vmem  # noqa: F401
from repro_torch.chip.topology import TOPOLOGIES, ChipView, LinkClass, TopologyModel, build_topology  # noqa: F401
