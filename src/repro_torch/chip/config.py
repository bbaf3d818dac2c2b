"""ICCA chip hardware descriptions (paper §2.1, §6.1).

A ``ChipConfig`` is the hardware vocabulary shared by the ELK compiler core,
the event-driven simulator, and the TPU integration layer.  All bandwidths are
bytes/s, capacities bytes, compute FLOP/s.
"""

from __future__ import annotations

import dataclasses

from repro_torch.chip.topology import (TOPOLOGIES, ChipView, TopologyModel,
                                 build_topology, near_square_grid)

# Registry key into chip/topology.TOPOLOGIES ("all2all", "mesh2d",
# "torus2d", "ring", "hier_pod", ...); kept as a plain str alias so the
# pre-refactor annotations stay valid.
Topology = str

KB = 1024
MB = 1024 * KB
GB = 1024 * MB
TB = 1024 * GB


@dataclasses.dataclass(frozen=True)
class MemoryTier:
    """One level of the chip's memory hierarchy (DESIGN.md §10).

    Ordered fastest (tier 0 = the cores' SRAM) to slowest (the unbounded
    backing store, HBM/DRAM).  ``capacity <= 0`` marks the backing tier:
    it holds everything that is not staged closer to the cores.
    """
    name: str
    capacity: int          # aggregate bytes; <= 0 = unbounded backing store
    bandwidth: float       # aggregate bytes/s toward the cores
    latency: float = 0.0   # per-request latency (s)
    controllers: int = 1

    @property
    def unbounded(self) -> bool:
        return self.capacity <= 0


# An ordered MemoryTier list; plain tuple alias so specs stay hashable and
# usable inside the frozen ChipConfig / cache keys.
MemorySpec = tuple

# Tier names synthesized from the legacy scalar fields.  Custom tiers in
# ``mem_tiers`` may use any other name; these two are always rebuilt from
# ``sram_per_core``/``hbm_*`` so the scalars stay the single source of
# truth (and ``scaled()``/``dataclasses.replace`` can never desync them).
_RESERVED_TIER_NAMES = ("sram", "hbm")


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    """One ICCA chip (or a multi-chip pod treated as one flat core pool)."""

    name: str
    num_cores: int
    sram_per_core: int                 # bytes of local scratchpad per core
    core_flops: float                  # peak FLOP/s of one core (matmul)
    core_flops_vector: float           # peak FLOP/s of one core (non-matmul)
    sram_bw_per_core: float            # local SRAM read bandwidth per core
    link_bw: float                     # one inter-core link (per direction)
    topology: Topology = "all2all"
    num_chips: int = 1                 # multi-chip pod: NoC topology is per-chip
    mesh_dims: tuple[int, int] = (0, 0)    # per-chip mesh; (0,0) -> near-square
    # hier_pod: inter-chip tier = inter_links_per_chip gateway links per chip,
    # each at inter_bw_ratio * link_bw (a distinct, slower link class).
    inter_bw_ratio: float = 0.25
    inter_links_per_chip: int = 8
    hbm_bw: float = 0.0                # aggregate off-chip bandwidth
    hbm_controllers: int = 4
    hbm_latency: float = 1e-6          # per-request latency (s)
    link_latency: float = 5e-7         # per-hop latency (s)
    # Per-core reserved bytes (paper §5: 8KB inter-core receive buffer).
    reserved_per_core: int = 8 * KB
    # IPU-style SRAM port contention: remote reads block local compute (§2.3 ③,
    # footnote 2).  False for chips whose local memory is dual-ported.
    sram_port_blocking: bool = True
    # Ordered memory hierarchy (DESIGN.md §10).  ``__post_init__`` always
    # canonicalizes this to  (sram, *middle tiers, hbm?)  where the "sram"
    # and "hbm" tiers are synthesized from the scalar fields above (hbm only
    # when hbm_bw > 0) and the middle tiers (e.g. stacked DRAM) are kept from
    # whatever was passed in.  Callers only ever *add* middle tiers — via
    # ``with_stacked_dram()`` or by passing an existing ``mem_tiers`` through
    # ``scaled()`` — so legacy scalar updates can never desync the spec.
    mem_tiers: MemorySpec = ()

    def __post_init__(self):
        # fail at the construction site, not at the first chip.topo access
        # deep inside a compile
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"known: {sorted(TOPOLOGIES)}")
        if self.topology == "hier_pod" and (
                self.inter_bw_ratio <= 0 or self.inter_links_per_chip <= 0):
            raise ValueError(
                "hier_pod needs inter_bw_ratio > 0 and "
                f"inter_links_per_chip > 0, got {self.inter_bw_ratio!r} / "
                f"{self.inter_links_per_chip!r}")
        middles = tuple(t for t in self.mem_tiers
                        if t.name not in _RESERVED_TIER_NAMES)
        names = [t.name for t in middles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate memory tier names: {names}")
        for t in middles:
            if t.capacity <= 0 or t.bandwidth <= 0:
                raise ValueError(
                    f"middle memory tier {t.name!r} needs capacity > 0 and "
                    f"bandwidth > 0 (only the synthesized backing tier is "
                    f"unbounded), got {t.capacity!r} / {t.bandwidth!r}")
        tiers = (MemoryTier("sram", self.total_sram,
                            self.num_cores * self.sram_bw_per_core,
                            0.0, self.num_cores),) + middles
        if self.hbm_bw > 0:
            tiers += (MemoryTier("hbm", 0, self.hbm_bw, self.hbm_latency,
                                 self.hbm_controllers),)
        object.__setattr__(self, "mem_tiers", tiers)

    # ---- derived -----------------------------------------------------------
    @property
    def total_sram(self) -> int:
        return self.num_cores * (self.sram_per_core - self.reserved_per_core)

    @property
    def usable_sram_per_core(self) -> int:
        return self.sram_per_core - self.reserved_per_core

    @property
    def total_flops(self) -> float:
        return self.num_cores * self.core_flops

    @property
    def interconnect_bw(self) -> float:
        """Aggregate all-to-all interconnect bandwidth (paper: 1472*5.5GB/s)."""
        return self.num_cores * self.link_bw

    @property
    def cores_per_chip(self) -> int:
        return self.num_cores // max(self.num_chips, 1)

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """Per-chip mesh grid (paper §6.1 simulates 4 chips, each its own NoC)."""
        if self.topology not in ("mesh2d", "torus2d"):
            raise ValueError("mesh_shape on non-mesh chip")
        if self.mesh_dims != (0, 0):
            return self.mesh_dims
        return near_square_grid(self.cores_per_chip)

    # ---- NoC traffic model --------------------------------------------------
    # Delegated to the pluggable topology subsystem (chip/topology.py): the
    # bound TopologyModel owns routing hop weights, per-link-class capacities
    # and collective cost shapes; the properties below are the back-compat
    # scalar vocabulary the compiler core and simulator consume.
    @property
    def topo(self) -> TopologyModel:
        # memoized on the instance: hashing the whole dataclass per lookup
        # is too slow for the allocator/scheduler hot paths
        t = self.__dict__.get("_topo")
        if t is None:
            t = build_topology(self)
            object.__setattr__(self, "_topo", t)
        return t

    @property
    def topo_signature(self) -> tuple:
        """Hashable topology identity for compile-pipeline cache keys."""
        return self.topo.signature()

    # ---- memory hierarchy (DESIGN.md §10) ----------------------------------
    @property
    def mem_signature(self) -> tuple:
        """Hashable memory-hierarchy identity for compile-pipeline cache
        keys (the tier-list analogue of ``topo_signature``)."""
        s = self.__dict__.get("_mem_sig")
        if s is None:
            s = tuple((t.name, t.capacity, t.bandwidth, t.latency,
                       t.controllers) for t in self.mem_tiers)
            object.__setattr__(self, "_mem_sig", s)
        return s

    @property
    def backing_tier(self) -> int:
        """Index of the tier that holds everything not staged closer to the
        cores: the unbounded hbm tier when present, else the last tier."""
        return len(self.mem_tiers) - 1

    @property
    def staging_tiers(self) -> tuple[int, ...]:
        """Indices of capacity-bounded off-core tiers weight blocks can be
        staged into (everything strictly between SRAM and the backing
        store; empty for the default two-tier chips)."""
        last = self.backing_tier
        return tuple(k for k in range(1, len(self.mem_tiers))
                     if k != last and not self.mem_tiers[k].unbounded)

    def tier_capacity_per_core(self, tier: int) -> int:
        """One core's share of a tier's capacity (tier 0 = the usable local
        scratchpad; deeper tiers are chip-shared, split evenly)."""
        if tier <= 0:
            return self.usable_sram_per_core
        t = self.mem_tiers[tier]
        return t.capacity // max(self.num_cores, 1) if t.capacity > 0 else 0

    @property
    def noc_capacity(self) -> float:
        return self.topo.total_capacity

    @property
    def preload_hops(self) -> float:
        return self.topo.preload_hops

    @property
    def dist_hops(self) -> float:
        return self.topo.dist_hops

    @property
    def preload_noc_bw(self) -> float:
        """Effective HBM-controller->cores delivery bandwidth over the NoC."""
        return self.topo.preload_delivery_bw

    def noc_occupancy(self, exec_bytes: float, preload_bytes: float,
                      dist_bytes: float = 0.0) -> float:
        """Seconds of link capacity consumed by a traffic mix (bottleneck
        tier for multi-class topologies)."""
        return self.topo.occupancy(exec_bytes, preload_bytes, dist_bytes)

    def chip_view(self, width: int = 1) -> ChipView:
        """One member chip of this pod + the inter-chip tier a pipeline
        stage boundary crosses (DESIGN.md §7).  ``width > 1`` tags the view
        as one shard of a tensor-parallel stage spanning ``width`` member
        chips (DESIGN.md §9)."""
        return self.topo.chip_view(width)

    def collective_time(self, kind: str, nbytes: float, width: int,
                        link_class: str | None = None) -> float:
        """Ring-collective time among ``width`` member chips (DESIGN.md §9)."""
        return self.topo.collective_time(kind, nbytes, width, link_class)

    def scaled(self, mem_divide: float = 1, **kw) -> "ChipConfig":
        """``dataclasses.replace`` plus memory-hierarchy scaling:
        ``mem_divide=n`` hands out a 1/n share of every middle tier (used by
        ``chip_view()`` to derive one member chip of a pod — the sram/hbm
        tiers rescale automatically from the scalar fields)."""
        if mem_divide != 1:
            src = kw.get("mem_tiers", self.mem_tiers)
            kw["mem_tiers"] = tuple(
                dataclasses.replace(
                    t,
                    capacity=int(t.capacity / mem_divide),
                    bandwidth=t.bandwidth / mem_divide,
                    controllers=max(int(t.controllers / mem_divide), 1))
                for t in src if t.name not in _RESERVED_TIER_NAMES)
        return dataclasses.replace(self, **kw)

    def with_stacked_dram(self, capacity: int = 8 * GB,
                          bandwidth: float = 2 * TB, *,
                          latency: float = 5e-7, controllers: int = 8,
                          name: str = "stacked") -> "ChipConfig":
        """This chip plus a 3D-stacked DRAM tier between SRAM and HBM
        (Voxel/DeepStack direction, DESIGN.md §10) — the sweepable design
        point ``chip/dse.tier_sweep`` explores."""
        tier = MemoryTier(name, capacity, bandwidth, latency, controllers)
        middles = tuple(t for t in self.mem_tiers
                        if t.name not in _RESERVED_TIER_NAMES)
        return dataclasses.replace(self, mem_tiers=middles + (tier,))


# ---------------------------------------------------------------------------
# Reference chips
# ---------------------------------------------------------------------------

def ipu_mk2() -> ChipConfig:
    """One Graphcore IPU MK2 (paper §2.1): 1472 cores x 624KB, 5.5GB/s links."""
    return ChipConfig(
        name="ipu-mk2",
        num_cores=1472,
        sram_per_core=624 * KB,
        # 250 TFLOPS/chip fp16 => ~170 GFLOPS/core for matmul; vector ~1/32.
        core_flops=250e12 / 1472,
        core_flops_vector=31.2e12 / 1472,
        sram_bw_per_core=128 / 8 * 1.325e9,  # 128 bits/cycle @ 1.325GHz (§2.3)
        link_bw=5.5 * GB,
        topology="all2all",
        hbm_bw=0.0,
    )


def ipu_pod4_hbm(hbm_bw: float = 16 * TB, topology: Topology = "all2all") -> ChipConfig:
    """The paper's emulator target: IPU-POD4 (4xMK2 = 5888 cores, 3.5GB SRAM)
    + 4 HBM3E modules per chip => 16TB/s aggregate (paper §6.1)."""
    return ChipConfig(
        name="ipu-pod4-hbm",
        num_cores=5888,
        sram_per_core=624 * KB,
        core_flops=1000e12 / 5888,          # 1 PFLOPS pod for MatMul (paper §6.3)
        core_flops_vector=4 * 31.2e12 / 5888,
        sram_bw_per_core=128 / 8 * 1.325e9,  # 128 bits/cycle @1.325GHz (paper §2.3)
        link_bw=5.5 * GB,
        topology=topology,
        num_chips=4,
        hbm_bw=hbm_bw,
        hbm_controllers=16,                  # 4 modules x 4 chips
        sram_port_blocking=True,
    )


def tpu_v5e_pod(num_chips: int = 256) -> ChipConfig:
    """A TPU v5e pod read as one ICCA chip (DESIGN.md §3A): chips=cores,
    ICI=inter-core links, per-chip HBM='SRAM', host DRAM/the pod's own sharded
    weight store = 'off-chip'.  Constants per the assignment: 197 TFLOP/s bf16,
    819 GB/s HBM, ~50 GB/s/link ICI."""
    return ChipConfig(
        name=f"tpu-v5e-{num_chips}",
        num_cores=num_chips,
        sram_per_core=16 * GB,              # per-chip HBM as the local store
        core_flops=197e12,
        core_flops_vector=197e12 / 16,
        sram_bw_per_core=819 * GB,
        link_bw=50 * GB,
        topology="mesh2d",
        mesh_dims=(16, num_chips // 16) if num_chips % 16 == 0 else (0, 0),
        hbm_bw=819 * GB * num_chips * 0.1,  # host->HBM aggregate (DCN-limited)
        hbm_controllers=num_chips // 4,
        link_latency=1e-6,
        sram_port_blocking=False,           # HBM not blocked by ICI traffic
        reserved_per_core=0,
    )


def tpu_v5e_pod_hier(num_chips: int = 256, groups: int = 4) -> ChipConfig:
    """The TPU pod read as a hierarchical multi-chip pod (DESIGN.md §7):
    ``groups`` islands of chips, each island an all2all ICI domain, behind a
    thinner DCN-like tier.  This is the pod model the pipeline-parallel
    planner partitions the layer stack over."""
    flat = tpu_v5e_pod(num_chips)
    return flat.scaled(
        name=f"tpu-v5e-{num_chips}x{groups}",
        topology="hier_pod",
        num_chips=groups,
        mesh_dims=(0, 0),
        inter_bw_ratio=0.1,               # DCN egress ~5 GB/s per link
        inter_links_per_chip=max(num_chips // (4 * groups), 1))


def tpu_v5e_vmem() -> ChipConfig:
    """One TPU v5e chip read as an ICCA chip at the VMEM level (DESIGN.md §3B):
    the single TensorCore's VMEM is the on-chip memory, HBM the off-chip one.
    Used by core/integration.vmem_plan() to pick Pallas block shapes."""
    return ChipConfig(
        name="tpu-v5e-vmem",
        num_cores=1,
        sram_per_core=128 * MB,
        core_flops=197e12,
        core_flops_vector=197e12 / 16,
        sram_bw_per_core=40 * TB,           # VMEM->MXU feed bandwidth (approx)
        link_bw=819 * GB,                   # 'interconnect' = HBM bus
        topology="all2all",
        hbm_bw=819 * GB,
        hbm_controllers=1,
        sram_port_blocking=False,
        reserved_per_core=0,
    )
