"""Pluggable interconnect topology models (paper §5 mapping strategies, §6.4).

The paper's second headline claim is that the ICCA simulator enables
"architecture design space exploration with different interconnect network
topologies".  This module makes topology a first-class axis: each
:class:`TopologyModel` owns

* **routing** — per-traffic-class hop weights (``preload`` delivery from the
  HBM controllers, ``dist`` peer fetches at the preload->execute transition,
  ``rot`` compute-shift rotation / ring-reduce traffic during execution),
  HBM-controller placement, and bisection capacity;
* **link classes** — the contended resource pools the event simulator
  processor-shares.  Flat topologies expose one ``intra`` class; the
  hierarchical multi-chip pod adds a distinct, slower ``inter`` tier so
  congestion on one tier stretches only the flows that cross it;
* **collective cost shapes** — the serial-time factors the analytic cost
  model applies to broadcast preload, rotation and distribution transfers,
  so ELK's plans (not just the simulator) react to topology.

``ChipConfig`` delegates its NoC vocabulary (``noc_capacity``,
``preload_hops``, ``dist_hops``, ``preload_noc_bw``, ``noc_occupancy``) to
the model bound by :func:`build_topology`; ``signature()`` feeds the compile
pipeline's cache keys so curves/windows/plans miss when topology changes.

Numeric compatibility: ``all2all`` and ``mesh2d`` reproduce the pre-refactor
scalar hop-weight constants exactly (capacity ``N*link`` / ``4N*link``,
preload hops ``1`` / ``(r+c)/4``, dist hops ``1`` / ``2``, unit serial-time
factors), so existing plans are bit-identical.
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import cached_property, lru_cache
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoid a circular import; chip/config.py imports us
    from repro_torch.chip.config import ChipConfig

TRAFFIC_CLASSES = ("preload", "dist", "rot")

# collective shapes the hybrid pod planner prices (DESIGN.md §9): ring
# algorithms over the member chips of a pod, on the tier a chip-to-chip
# transfer crosses
COLLECTIVE_KINDS = ("all_reduce", "reduce_scatter", "all_gather",
                    "all_to_all")


@dataclasses.dataclass(frozen=True)
class LinkClass:
    """One contended interconnect tier (fluid capacity pool)."""
    name: str            # "intra" | "inter"
    capacity: float      # aggregate bytes/s of the tier
    hop_latency: float   # per-hop latency on this tier (s)


@dataclasses.dataclass(frozen=True)
class ChipView:
    """Projection of a pod topology onto one member chip (DESIGN.md §7).

    ``chip`` is a ``ChipConfig`` describing a single member chip — the pod's
    per-chip core pool, SRAM, and HBM share with ``num_chips=1``, so its own
    ``topo`` exposes only the intra-chip link classes.  ``inter_bw`` /
    ``inter_latency`` expose the inter-chip tier a stage-to-stage activation
    flow crosses: the bandwidth one chip-pair boundary can sustain (one
    chip's gateway links on ``hier_pod``; a bisection share on flat pools)
    and the per-transfer latency across the tier.
    """
    chip: "ChipConfig"
    num_chips: int
    inter_bw: float
    inter_latency: float
    #: tensor-parallel width of the stage this view serves.  The member chip
    #: itself is unchanged (per-chip HBM bandwidth and SRAM are physical);
    #: the byte division lives in the sharded graph the planner compiles
    #: against this view (``pipeline_pod.shard_graph``, DESIGN.md §9), and
    #: the intra-stage collective term is priced by ``collective_time``.
    width: int = 1


def near_square_grid(n: int) -> tuple[int, int]:
    """Near-square factorization of ``n`` cores into a 2D grid.

    Prime (and near-prime) ``n`` degenerates to a pencil — ``(1, n)`` or
    e.g. ``(2, 23)`` — silently inflating ``preload_hops``; whenever the
    best factorization is worse than 2:1, pad to the nearest count whose
    grid is at most 2:1 instead (idle grid slots, honest hop counts) and
    warn.
    """
    def factor(m: int) -> tuple[int, int]:
        r = int(m ** 0.5)
        while m % r:
            r -= 1
        return (r, m // r)

    r, c = factor(n)
    if c > 2 * r:
        m = n + 1
        while True:
            r, c = factor(m)
            if r > 1 and c <= 2 * r:
                break
            m += 1
        warnings.warn(
            f"near-square grid: {n} cores has no near-square "
            f"factorization; padding to a {r}x{c} grid ({r * c - n} idle "
            "slots)", stacklevel=2)
    return (r, c)


class TopologyModel:
    """Base interconnect model bound to one chip's shape.

    Subclasses fill in, from the chip fields captured here:

    * ``classes`` — tuple of :class:`LinkClass` pools;
    * ``weights`` — ``{traffic kind: {class name: hop weight}}``; a flow of
      ``B`` bytes of kind ``k`` puts ``B * weights[k][c]`` byte-hops on
      class ``c``;
    * ``preload_hops`` / ``dist_hops`` / ``rot_hops`` — scalar summaries
      (mean hop counts) used for reporting and back-compat;
    * ``dist_time_factor`` / ``rot_time_factor`` — serial per-core transfer
      time multipliers on ``volume / link_bw`` (slow-tier crossings);
    * ``dist_latency_hops`` / ``rot_latency_hops`` — hop counts charged as
      per-transfer latency by the analytic cost model and the simulator.
    """

    kind = "base"

    def __init__(self, chip: "ChipConfig"):
        self._chip = chip
        self.num_cores = chip.num_cores
        self.num_chips = max(chip.num_chips, 1)
        self.cores_per_chip = chip.cores_per_chip
        self.link_bw = chip.link_bw
        self.link_latency = chip.link_latency
        self.hbm_controllers = chip.hbm_controllers
        self.classes: tuple[LinkClass, ...] = ()
        self.weights: dict[str, dict[str, float]] = {}
        self.preload_hops = 1.0
        self.dist_hops = 1.0
        self.rot_hops = 1.0
        self.dist_time_factor = 1.0
        self.rot_time_factor = 1.0
        self.dist_latency_hops = 1.0
        self.rot_latency_hops = 1.0
        self.bisection_bw = 0.0

    # -- interface the compiler core / simulator consume ---------------------
    # (total_capacity / preload_delivery_bw / signature sit on scheduler and
    # allocator hot paths — computed once per model, then plain lookups)
    def flow_weights(self, kind: str) -> dict[str, float]:
        return self.weights[kind]

    @cached_property
    def total_capacity(self) -> float:
        return sum(lc.capacity for lc in self.classes)

    @cached_property
    def preload_delivery_bw(self) -> float:
        """Effective HBM-controller->cores delivery bandwidth: the bottleneck
        link class's capacity diluted by the preload hop weight it carries."""
        return min(lc.capacity / self.weights["preload"][lc.name]
                   for lc in self.classes
                   if self.weights["preload"].get(lc.name, 0.0) > 0.0)

    @cached_property
    def preload_latency(self) -> float:
        """Pipeline-fill latency of one broadcast-preload delivery (s)."""
        return self.preload_hops * self.classes[0].hop_latency

    @cached_property
    def dist_latency(self) -> float:
        """Per-transfer latency of one data-distribution fetch (s), summed
        over the hop latencies of the link classes it crosses."""
        return self.dist_latency_hops * self.classes[0].hop_latency

    @cached_property
    def _occ_terms(self) -> tuple:
        # flattened (1/capacity, rot_w, preload_w, dist_w) per class: the
        # allocator calls occupancy() per candidate window, so keep it a
        # few multiplies rather than dict lookups
        return tuple((1.0 / lc.capacity,
                      self.weights["rot"].get(lc.name, 0.0),
                      self.weights["preload"].get(lc.name, 0.0),
                      self.weights["dist"].get(lc.name, 0.0))
                     for lc in self.classes)

    def occupancy(self, exec_bytes: float, preload_bytes: float,
                  dist_bytes: float = 0.0) -> float:
        """Seconds of capacity consumed by a traffic mix: the bottleneck
        tier's weighted byte-hops over its capacity (flat topologies reduce
        to the single-pool ``weighted / noc_capacity`` of the seed model)."""
        terms = self._occ_terms
        inv, rw, pw, dw = terms[0]
        t = (exec_bytes * rw + preload_bytes * pw + dist_bytes * dw) * inv
        for inv, rw, pw, dw in terms[1:]:
            t = max(t, (exec_bytes * rw + preload_bytes * pw
                        + dist_bytes * dw) * inv)
        return t

    def chip_view(self, width: int = 1) -> ChipView:
        """Project the pod onto one member chip (DESIGN.md §7, §9).

        The member ``ChipConfig`` keeps this chip's share of every per-chip
        resource (cores, SRAM, HBM bandwidth and controllers) with
        ``num_chips=1``, so planning against it sees only intra-chip link
        classes.  The inter-chip tier is exposed separately as the bandwidth
        one stage-to-stage boundary sustains.  Flat pools (no distinct inter
        tier) attribute a bisection share per chip-pair boundary; a
        single-chip config projects to itself with the full on-chip
        bisection as the (never-crossed) boundary bandwidth.

        ``width > 1`` marks the view as serving one shard of a stage that
        spans ``width`` member chips: the per-chip resources are unchanged,
        the weight/KV byte division is applied by the sharded stage graph
        compiled against this view, and the intra-stage collective term is
        priced separately via :meth:`collective_time`.
        """
        self._check_width(width)
        chip = self._chip
        n = self.num_chips
        if n <= 1:
            return ChipView(chip, 1, self.bisection_bw, chip.link_latency)
        member = chip.scaled(
            name=f"{chip.name}/chip",
            num_cores=self.cores_per_chip, num_chips=1,
            hbm_bw=chip.hbm_bw / n,
            hbm_controllers=max(chip.hbm_controllers // n, 1),
            mem_divide=n)
        return ChipView(member, n, self.bisection_bw / max(n - 1, 1),
                        2 * chip.link_latency, width)

    def _check_width(self, width: int) -> None:
        if not 1 <= width <= max(self.num_chips, 1):
            raise ValueError(
                f"width {width} out of range for a {self.num_chips}-chip "
                f"{self.kind} pod (need 1 <= width <= num_chips)")

    # -- collective cost API (hybrid pod planner, DESIGN.md §9) --------------
    def _collective_boundary(self, link_class: str | None) -> tuple:
        """(bandwidth, per-step latency) of one chip-pair boundary on the
        tier a ring collective's steps cross.  Matches ``chip_view()``'s
        inter-tier numbers exactly so the planner's send and collective
        terms price the same physical links."""
        names = [lc.name for lc in self.classes]
        if link_class is None:
            link_class = "inter" if "inter" in names else names[0]
        if link_class not in names:
            raise ValueError(
                f"unknown link class {link_class!r} on {self.kind}; "
                f"known: {names}")
        # flat pools: every tier is the on-chip pool; a chip-pair boundary
        # sustains a bisection share, two hop latencies per step
        return (self.bisection_bw / max(self.num_chips - 1, 1),
                2 * self.link_latency)

    def collective_time(self, kind: str, nbytes: float, width: int,
                        link_class: str | None = None) -> float:
        """Ring-algorithm time (s) of one collective among ``width`` member
        chips, each contributing/holding ``nbytes`` of payload.

        Shapes (``COLLECTIVE_KINDS``): reduce-scatter and all-gather each
        move ``(width-1)/width * nbytes`` through one chip-pair boundary in
        ``width-1`` latency-bearing steps; all-reduce composes the two
        (RS + AG, the standard ring decomposition); all-to-all keeps
        ``1/width`` of the payload local and rings the rest, which costs
        the same single pass.  Degenerate cases (``width <= 1`` or zero
        bytes) are free so pure-pipeline plans are untouched.
        """
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}; known: "
                             f"{COLLECTIVE_KINDS}")
        self._check_width(max(width, 1))
        if width <= 1 or nbytes <= 0:
            return 0.0
        bw, lat = self._collective_boundary(link_class)
        steps = width - 1
        single_pass = (nbytes * steps / width) / bw + steps * lat
        return 2.0 * single_pass if kind == "all_reduce" else single_pass

    def signature(self) -> tuple:
        """Hashable identity for compile-pipeline cache keys (memoized)."""
        sig = self.__dict__.get("_sig")
        if sig is None:
            sig = self.__dict__["_sig"] = self._signature()
        return sig

    def _signature(self) -> tuple:
        return (self.kind, self.num_cores, self.num_chips, self.link_bw,
                tuple((lc.name, lc.capacity) for lc in self.classes),
                tuple(sorted((k, tuple(sorted(w.items())))
                             for k, w in self.weights.items())),
                self.dist_time_factor, self.rot_time_factor,
                self.preload_hops)


class All2AllTopology(TopologyModel):
    """Every core drives one full-bandwidth link at a time (IPU exchange):
    capacity ``N * link_bw``, every transfer is one hop."""

    kind = "all2all"

    def __init__(self, chip):
        super().__init__(chip)
        cap = self.num_cores * self.link_bw
        self.classes = (LinkClass("intra", cap, self.link_latency),)
        self.weights = {"preload": {"intra": 1.0},
                        "dist": {"intra": 1.0},
                        "rot": {"intra": 1.0}}
        self.bisection_bw = cap / 2.0
        self.preload_hops = 1.0
        self.dist_hops = 1.0


class Mesh2DTopology(TopologyModel):
    """Per-chip 2D mesh, dimension-order routing (paper §6.1): each core
    talks to up to 4 neighbors simultaneously => capacity ``4N * link_bw``;
    a transfer consumes one link per hop.  Partition dims map to mesh dims,
    so rotations are neighbor hops (1) and distribution fetches within a
    group span ~2 hops; HBM controllers sit on the grid edges, so preload
    traffic crosses ``(rows+cols)/4`` links on average."""

    kind = "mesh2d"

    def __init__(self, chip):
        super().__init__(chip)
        r, c = chip.mesh_shape
        self.grid = (r, c)
        cap = 4 * self.num_cores * self.link_bw
        self.classes = (LinkClass("intra", cap, self.link_latency),)
        self.preload_hops = max((r + c) / 4.0, 1.0)
        self.dist_hops = 2.0
        self.weights = {"preload": {"intra": self.preload_hops},
                        "dist": {"intra": self.dist_hops},
                        "rot": {"intra": 1.0}}
        self.bisection_bw = min(r, c) * self.link_bw * self.num_chips

    def _signature(self) -> tuple:
        return super()._signature() + (self.grid,)


class Torus2DTopology(Mesh2DTopology):
    """Mesh2D with wraparound links: the same 4 links per core, but mean
    routing distances halve (preload crosses ``(r+c)/8``, distribution
    ~1.5 hops) and the bisection doubles.  Rotation stays a true ring of
    neighbor hops, so at equal ``link_bw`` torus rotation time is never
    worse than mesh."""

    kind = "torus2d"

    def __init__(self, chip):
        super().__init__(chip)
        r, c = self.grid
        self.preload_hops = max((r + c) / 8.0, 1.0)
        self.dist_hops = 1.5
        self.weights = {"preload": {"intra": self.preload_hops},
                        "dist": {"intra": self.dist_hops},
                        "rot": {"intra": 1.0}}
        self.bisection_bw = 2 * min(r, c) * self.link_bw * self.num_chips


class RingTopology(TopologyModel):
    """Per-chip bidirectional ring: two links per core => capacity
    ``2N * link_bw``.  HBM controllers are spaced evenly around the ring,
    so broadcast preload travels ``cores_per_chip / (4 * controllers)``
    hops on average — rings scale poorly for delivery, which is the point
    of including one in the DSE sweep.  Rotation is the natural fit (ring
    neighbors), distribution crosses ~4 hops."""

    kind = "ring"

    def __init__(self, chip):
        super().__init__(chip)
        cap = 2 * self.num_cores * self.link_bw
        self.classes = (LinkClass("intra", cap, self.link_latency),)
        ctrl_per_chip = max(self.hbm_controllers // self.num_chips, 1)
        self.preload_hops = max(
            self.cores_per_chip / (4.0 * ctrl_per_chip), 1.0)
        self.dist_hops = 4.0
        self.dist_time_factor = 2.0
        self.dist_latency_hops = 2.0
        self.weights = {"preload": {"intra": self.preload_hops},
                        "dist": {"intra": self.dist_hops},
                        "rot": {"intra": 1.0}}
        self.bisection_bw = 2 * self.link_bw * self.num_chips


class HierPodTopology(TopologyModel):
    """Hierarchical multi-chip pod: each chip is all2all internally
    (``intra`` class, per-chip HBM controllers => preload never leaves the
    chip) while chips connect through a distinct, slower ``inter`` tier of
    ``inter_links_per_chip`` gateway links per chip at
    ``inter_bw_ratio * link_bw`` each.  Distribution fetches peers
    uniformly, so ``(num_chips-1)/num_chips`` of that traffic crosses the
    thin tier; a rotation ring laid out chip-contiguously crosses it only
    ``num_chips / num_cores`` of the time.  Serial transfer times stretch
    by the harmonic blend of the two tiers' speeds."""

    kind = "hier_pod"

    def __init__(self, chip):
        super().__init__(chip)
        ratio = chip.inter_bw_ratio
        intra_cap = self.num_cores * self.link_bw
        inter_cap = (self.num_chips * chip.inter_links_per_chip
                     * self.link_bw * ratio)
        self.classes = (LinkClass("intra", intra_cap, self.link_latency),
                        LinkClass("inter", inter_cap, 4 * self.link_latency))
        fi = (self.num_chips - 1) / self.num_chips if self.num_chips > 1 \
            else 0.0
        fr = min(1.0, self.num_chips / self.num_cores) if self.num_chips > 1 \
            else 0.0
        self.frac_dist_inter = fi
        self.frac_rot_inter = fr
        self.preload_hops = 1.0
        self.dist_hops = 1.0 + fi
        self.dist_time_factor = (1.0 - fi) + fi / ratio
        self.rot_time_factor = (1.0 - fr) + fr / ratio
        self.weights = {"preload": {"intra": 1.0},
                        "dist": {"intra": 1.0, "inter": fi},
                        "rot": {"intra": 1.0, "inter": fr}}
        self.bisection_bw = inter_cap / 2.0 if self.num_chips > 1 \
            else intra_cap / 2.0

    @cached_property
    def dist_latency(self) -> float:
        # one intra hop to the gateway + one (slower) inter-chip hop; a
        # single-chip pod never crosses the gateway, so it must match the
        # corresponding flat all2all chip exactly (degenerate equivalence,
        # tests/test_pipeline_pod.py)
        by = {lc.name: lc.hop_latency for lc in self.classes}
        if self.num_chips <= 1:
            return by["intra"]
        return by["intra"] + by["inter"]

    def chip_view(self, width: int = 1) -> ChipView:
        self._check_width(width)
        chip = self._chip
        n = self.num_chips
        if n <= 1:
            by = {lc.name: lc.hop_latency for lc in self.classes}
            return ChipView(chip, 1, self.bisection_bw, by["intra"])
        member = chip.scaled(
            name=f"{chip.name}/chip",
            num_cores=self.cores_per_chip, num_chips=1,
            hbm_bw=chip.hbm_bw / n,
            hbm_controllers=max(chip.hbm_controllers // n, 1),
            mem_divide=n)
        # one boundary = the sending chip's gateway links; hops: one intra
        # hop to the gateway + one inter-chip hop
        by = {lc.name: lc.hop_latency for lc in self.classes}
        return ChipView(member, n,
                        chip.inter_links_per_chip * chip.link_bw
                        * chip.inter_bw_ratio,
                        by["intra"] + by["inter"], width)

    def _collective_boundary(self, link_class: str | None) -> tuple:
        # cross-chip collectives ride the gateway tier: one boundary = the
        # sending chip's gateway links, per-step latency = intra hop to the
        # gateway + one (slower) inter-chip hop — the same numbers
        # chip_view() exposes for stage-to-stage sends
        names = [lc.name for lc in self.classes]
        if link_class is None:
            link_class = "inter" if self.num_chips > 1 else "intra"
        if link_class not in names:
            raise ValueError(
                f"unknown link class {link_class!r} on {self.kind}; "
                f"known: {names}")
        if link_class == "inter" and self.num_chips > 1:
            chip = self._chip
            by = {lc.name: lc.hop_latency for lc in self.classes}
            return (chip.inter_links_per_chip * chip.link_bw
                    * chip.inter_bw_ratio,
                    by["intra"] + by["inter"])
        return super()._collective_boundary("intra")

    def _signature(self) -> tuple:
        return super()._signature() + (self.frac_dist_inter,
                                       self.frac_rot_inter)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A fleet of pods behind one router (DESIGN.md §12): per-pod
    ``ChipConfig``s plus the inter-pod tier a KV migration crosses.

    This extends the tiering pattern one level up, the way ``hier_pod``
    already stacks a slower ``inter`` gateway tier on top of each chip's
    ``intra`` links: the fleet adds a ``pod`` link class — datacenter
    fabric between pods — that is again thinner (``inter_bw_ratio`` of the
    slowest pod's bisection when not given explicitly) and again
    higher-latency (two pod-gateway hops on top of a fabric hop).  A
    prefill->decode migration's wire leg is priced here; the endpoint
    offload/refill legs are priced by each pod's own
    ``AnalyticCostModel.spill_time``, and ``chip.simulator.
    simulate_fleet_traffic`` re-serves all three legs on serial servers.
    """
    pods: tuple["ChipConfig", ...]
    inter_pod_bw: float = 0.0        # bytes/s one pod-pair boundary
    #                                  sustains (0 = derive from the pods)
    inter_pod_latency: float = 0.0   # per-transfer latency across the
    #                                  fleet tier (0 = derive)
    inter_bw_ratio: float = 0.25     # dilution vs the slowest pod's
    #                                  bisection when deriving

    def __post_init__(self):
        if not self.pods:
            raise ValueError("FleetSpec needs at least one pod")
        if self.inter_pod_bw <= 0:
            object.__setattr__(
                self, "inter_pod_bw",
                self.inter_bw_ratio
                * min(p.topo.bisection_bw for p in self.pods))
        if self.inter_pod_latency <= 0:
            # two pod-gateway crossings around one fabric hop, one tier
            # slower again than hier_pod's 4x-link-latency gateway
            object.__setattr__(
                self, "inter_pod_latency",
                8.0 * max(p.link_latency for p in self.pods))

    @property
    def num_pods(self) -> int:
        return len(self.pods)

    def link(self) -> LinkClass:
        """The fleet tier as a link class, same vocabulary as the intra
        and inter tiers below it."""
        return LinkClass("pod", self.inter_pod_bw, self.inter_pod_latency)

    def transfer_time(self, nbytes: float) -> float:
        """Wire time of one inter-pod transfer (the migration's middle
        leg): volume over the pod-pair boundary plus the fleet latency."""
        if nbytes <= 0:
            return 0.0
        return nbytes / self.inter_pod_bw + self.inter_pod_latency

    def migration_time(self, nbytes: float, src: int, dst: int) -> float:
        """Planned end-to-end cost of moving one KV ring from pod ``src``
        to pod ``dst``: offload off src's cores, the inter-pod wire, and
        the refill onto dst's cores — three serial legs, each priced by
        the tier it crosses."""
        from repro_torch.core.cost_model import AnalyticCostModel

        a, b = self.pods[src], self.pods[dst]
        return (AnalyticCostModel(a).spill_time(nbytes, 0, a.backing_tier)
                + self.transfer_time(nbytes)
                + AnalyticCostModel(b).spill_time(nbytes, 0, b.backing_tier))

    def signature(self) -> tuple:
        """Hashable identity, fleet tier included — the same role
        ``TopologyModel.signature()`` plays in plan cache keys."""
        return (("fleet", self.inter_pod_bw, self.inter_pod_latency)
                + tuple(p.topo.signature() for p in self.pods))


def fleet_spec(pod: "ChipConfig", num_pods: int, *,
               inter_pod_bw: float = 0.0,
               inter_pod_latency: float = 0.0) -> FleetSpec:
    """Homogeneous fleet: ``num_pods`` copies of one pod config."""
    if num_pods < 1:
        raise ValueError(f"num_pods must be >= 1, got {num_pods}")
    return FleetSpec(pods=(pod,) * num_pods, inter_pod_bw=inter_pod_bw,
                     inter_pod_latency=inter_pod_latency)


TOPOLOGIES: dict[str, type[TopologyModel]] = {
    cls.kind: cls for cls in (All2AllTopology, Mesh2DTopology,
                              Torus2DTopology, RingTopology,
                              HierPodTopology)
}


@lru_cache(maxsize=256)
def _build(chip: "ChipConfig") -> TopologyModel:
    try:
        cls = TOPOLOGIES[chip.topology]
    except KeyError:
        raise KeyError(f"unknown topology {chip.topology!r}; known: "
                       f"{sorted(TOPOLOGIES)}") from None
    return cls(chip)


def build_topology(chip: "ChipConfig") -> TopologyModel:
    """The (memoized) TopologyModel bound to a chip's shape."""
    return _build(chip)
