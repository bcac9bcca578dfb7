"""First-class interconnect graphs for topology-aware planning and analysis
(copy of ``repro.core.topology``).

The cost models in ``core.strategies`` price schedules per *logical ring
direction*; nothing so far said which physical wire a logical hop actually
crosses.  This module makes the link graph a value: devices, pods, and
per-link ``(bandwidth, duplex)`` attributes, plus named *placements* mapping
logical ring ranks onto devices.  ``ParallelContext.plan(topology=...)``
resolves ``"auto"`` against the graph — flat bidirectional TokenRing vs the
hierarchical 2D schedule is an arithmetic question once per-class
bandwidths are declared; ``analysis.topo_check`` replays a schedule's
rank-symbolic message walk onto these graphs' links (the TOPO-* findings).

Links are undirected edges with two independent lanes when ``duplex="full"``
(NVLink/ICI) or one shared lane when ``duplex="half"``.  Every link carries a
``cls`` label ("intra", "inter", ...) — the unit of per-class bandwidth in
the generalized ``CommCost.time_s({cls: bw})`` (see ``core.strategies``);
the ring transports count their sends under the same labels
(``core.collectives``).

Factories build the shapes the CI matrix checks: :func:`nvlink_pod` (one
full-duplex ring), :func:`two_pods` (two intra-pod rings bridged by
per-position inter-pod links — a 2 x n grid), :func:`half_duplex_pod`.
``two_pods`` ships two placements: ``"ring"``, a snake Hamiltonian cycle so a
*flat* ring schedule maps each logical hop onto exactly one physical link,
and ``"grid"``, row-major ``(pod, inner)`` coordinates for the hierarchical
2D schedule (``core.hier2d``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

__all__ = [
    "Link",
    "Topology",
    "nvlink_pod",
    "two_pods",
    "half_duplex_pod",
    "DEFAULT_INTRA_BW",
    "DEFAULT_INTER_BW",
]

# Default bandwidths (bytes/s per lane) for the factory topologies: an
# NVLink/ICI-class intra-pod link and a PCIe/IB-class inter-pod link.
DEFAULT_INTRA_BW = 50e9
DEFAULT_INTER_BW = 12.5e9


@dataclass(frozen=True)
class Link:
    """One undirected physical link between devices ``a`` and ``b``.

    ``bw`` is bytes/s *per lane*: a full-duplex link moves ``bw`` each way
    concurrently, a half-duplex link shares one ``bw`` lane between the
    directions.  ``cls`` groups links into bandwidth classes ("intra",
    "inter") — the granularity of the planner's per-class cost model.
    """

    a: int
    b: int
    bw: float
    duplex: str = "full"  # "full" | "half"
    cls: str = "intra"

    def __post_init__(self):
        if self.duplex not in ("full", "half"):
            raise ValueError(f"duplex must be 'full' or 'half': {self.duplex!r}")
        if self.a == self.b:
            raise ValueError(f"self-link on device {self.a}")

    @property
    def ends(self) -> frozenset:
        return frozenset((self.a, self.b))


@dataclass(frozen=True)
class Topology:
    """A named device/link graph with pods and logical-rank placements.

    ``pods`` partitions ``range(n_devices)``; ``placements`` maps a placement
    name to a rank → device permutation (``placements["ring"][r]`` is the
    device logical rank ``r`` lives on).
    """

    name: str
    n_devices: int
    links: tuple[Link, ...]
    pods: tuple[tuple[int, ...], ...]
    placements: Mapping[str, tuple[int, ...]] = field(default_factory=dict)

    def __post_init__(self):
        devs = sorted(d for pod in self.pods for d in pod)
        if devs != list(range(self.n_devices)):
            raise ValueError(
                f"pods {self.pods} do not partition range({self.n_devices})"
            )
        for link in self.links:
            if not (0 <= link.a < self.n_devices and 0 <= link.b < self.n_devices):
                raise ValueError(f"link {link} references unknown devices")
        for pname, perm in self.placements.items():
            if sorted(perm) != list(range(self.n_devices)):
                raise ValueError(
                    f"placement {pname!r} = {perm} is not a permutation of "
                    f"range({self.n_devices})"
                )

    # -- graph queries ------------------------------------------------------

    def link_between(self, a: int, b: int) -> Link | None:
        for link in self.links:
            if link.ends == frozenset((a, b)):
                return link
        return None

    def neighbors(self, dev: int) -> tuple[int, ...]:
        out = set()
        for link in self.links:
            if dev == link.a:
                out.add(link.b)
            elif dev == link.b:
                out.add(link.a)
        return tuple(sorted(out))

    def route(self, src: int, dst: int) -> tuple[tuple[int, int], ...]:
        """Directed hop sequence ``((u, v), ...)`` along a shortest path.

        Deterministic BFS (neighbors visited in sorted order) so the ledger
        is reproducible; raises if the graph is disconnected for the pair.
        """
        if src == dst:
            return ()
        prev: dict[int, int] = {src: src}
        frontier = [src]
        while frontier and dst not in prev:
            nxt: list[int] = []
            for u in frontier:
                for v in self.neighbors(u):
                    if v not in prev:
                        prev[v] = u
                        nxt.append(v)
            frontier = nxt
        if dst not in prev:
            raise ValueError(
                f"{self.name}: no path between devices {src} and {dst}"
            )
        path = [dst]
        while path[-1] != src:
            path.append(prev[path[-1]])
        path.reverse()
        return tuple(zip(path[:-1], path[1:]))

    def pod_of(self, dev: int) -> int:
        for i, pod in enumerate(self.pods):
            if dev in pod:
                return i
        raise ValueError(f"device {dev} is in no pod")

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    def placement(self, name: str) -> tuple[int, ...]:
        """Rank → device map; unknown names fall back to ``"ring"``."""
        if name in self.placements:
            return tuple(self.placements[name])
        if "ring" in self.placements:
            return tuple(self.placements["ring"])
        return tuple(range(self.n_devices))

    # -- bandwidth summaries (planner inputs) -------------------------------

    def class_bandwidths(self) -> dict[str, float]:
        """Per-class bandwidth: the *slowest* link of each class (exact for
        the homogeneous factory topologies, conservative otherwise)."""
        out: dict[str, float] = {}
        for link in self.links:
            out[link.cls] = min(out.get(link.cls, link.bw), link.bw)
        return out

    def half_duplex_classes(self) -> frozenset:
        return frozenset(
            link.cls for link in self.links if link.duplex == "half"
        )

    def bottleneck_bw(self) -> float:
        return min(link.bw for link in self.links)


def _ring_links(devices, bw, *, duplex="full", cls="intra"):
    n = len(devices)
    if n == 2:
        return [Link(devices[0], devices[1], bw, duplex=duplex, cls=cls)]
    return [
        Link(devices[i], devices[(i + 1) % n], bw, duplex=duplex, cls=cls)
        for i in range(n)
    ]


def nvlink_pod(n: int, *, bw: float = DEFAULT_INTRA_BW) -> Topology:
    """One pod of ``n`` devices on a full-duplex ring (NVLink/ICI style)."""
    return Topology(
        name=f"nvlink_pod({n})",
        n_devices=n,
        links=tuple(_ring_links(list(range(n)), bw)),
        pods=(tuple(range(n)),),
        placements={"ring": tuple(range(n))},
    )


def half_duplex_pod(n: int, *, bw: float = DEFAULT_INTRA_BW) -> Topology:
    """One pod of ``n`` devices whose ring links are half-duplex: the two
    directions share one lane, so bidirectional traffic serializes."""
    return Topology(
        name=f"half_duplex_pod({n})",
        n_devices=n,
        links=tuple(_ring_links(list(range(n)), bw, duplex="half")),
        pods=(tuple(range(n)),),
        placements={"ring": tuple(range(n))},
    )


def two_pods(
    n: int,
    *,
    intra_bw: float = DEFAULT_INTRA_BW,
    inter_bw: float = DEFAULT_INTER_BW,
    inter_duplex: str = "full",
) -> Topology:
    """Two ``n``-device pods, each a full-duplex intra ring, bridged by one
    inter-pod link per position (``i <-> n+i``) — a 2 x n grid.

    Placements: ``"ring"`` is the snake Hamiltonian cycle
    ``[0..n-1, 2n-1..n]`` (flat ring schedules cross exactly two inter-pod
    links per lap, each a real wire); ``"grid"`` is row-major ``(pod,
    inner)`` for the hierarchical 2D schedule.
    """
    if n < 2:
        raise ValueError("two_pods needs at least 2 devices per pod")
    pod0 = list(range(n))
    pod1 = list(range(n, 2 * n))
    links = (
        _ring_links(pod0, intra_bw)
        + _ring_links(pod1, intra_bw)
        + [
            Link(i, n + i, inter_bw, duplex=inter_duplex, cls="inter")
            for i in range(n)
        ]
    )
    snake = tuple(pod0) + tuple(reversed(pod1))
    return Topology(
        name=f"two_pods({n},inter_bw={inter_bw:g},{inter_duplex})",
        n_devices=2 * n,
        links=tuple(links),
        pods=(tuple(pod0), tuple(pod1)),
        placements={"ring": snake, "grid": tuple(range(2 * n))},
    )
