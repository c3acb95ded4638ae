"""Network topology simulator for the cost model.

Capability parity with reference src/runtime/network.cc (586 LoC):
topology generators (flat degree-constrained `FlatDegConstraintNetwork
TopologyGenerator` :481, big-switch `BigSwitchNetworkTopologyGenerator`)
and weighted shortest-path routing (`WeightedShortestPathRoutingStrategy`
:53), feeding a `NetworkedMachineModel` that costs a transfer along its
routed path (counterpart of ``flexflow_tpu/search/network.py``). On the
port's machine the inter-node InfiniBand fabric is the topology the
search routes over (``FFConfig.dcn_topology``, one node a GPU server):
a big switch for a non-blocking fat tree, or a degree-constrained or torus
graph for a thinner one; inside a node NVSwitch gives every pair the full
NVLink rate and needs no routing.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

Edge = Tuple[int, int]


class NetworkTopology:
    """Directed weighted graph over device ids; weight = link bandwidth
    (bytes/s). Latency per hop is a property of the machine model."""

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self.links: Dict[Edge, float] = {}
        self._adj: Dict[int, List[Tuple[int, float]]] = {}

    def add_link(self, a: int, b: int, bandwidth: float,
                 bidirectional: bool = True):
        def upsert(x, y, bw):
            adj = self._adj.setdefault(x, [])
            for i, (node, _old) in enumerate(adj):
                if node == y:      # re-adding updates the bandwidth in both
                    adj[i] = (y, bw)
                    break
            else:
                adj.append((y, bw))
            self.links[(x, y)] = bw

        upsert(a, b, bandwidth)
        if bidirectional:
            upsert(b, a, bandwidth)

    def neighbors(self, a: int):
        return self._adj.get(a, ())

    def degree(self, a: int) -> int:
        return len(self._adj.get(a, ()))


def torus_topology(dims: Sequence[int], link_bandwidth: float
                   ) -> NetworkTopology:
    """Torus generator (wrap-around links in each dimension; a 1-long dim
    contributes no link)."""
    dims = list(dims)
    n = 1
    for d in dims:
        n *= d
    topo = NetworkTopology(n)

    def flat(coord):
        idx = 0
        for c, d in zip(coord, dims):
            idx = idx * d + c
        return idx

    for coord in itertools.product(*[range(d) for d in dims]):
        for axis, d in enumerate(dims):
            if d <= 1:
                continue
            nxt = list(coord)
            nxt[axis] = (coord[axis] + 1) % d
            topo.add_link(flat(coord), flat(tuple(nxt)), link_bandwidth)
    return topo


def flat_degree_constrained_topology(num_nodes: int, degree: int,
                                     link_bandwidth: float,
                                     seed: int = 0) -> NetworkTopology:
    """Reference FlatDegConstraintNetworkTopologyGenerator (network.cc:481):
    a random regular-ish graph where every node has ~`degree` links."""
    import random

    rng = random.Random(seed)
    topo = NetworkTopology(num_nodes)
    # ring first for connectivity
    for i in range(num_nodes):
        topo.add_link(i, (i + 1) % num_nodes, link_bandwidth)
    attempts = 0
    while attempts < num_nodes * degree * 10:
        attempts += 1
        a, b = rng.randrange(num_nodes), rng.randrange(num_nodes)
        if a == b or (a, b) in topo.links:
            continue
        if topo.degree(a) >= degree or topo.degree(b) >= degree:
            continue
        topo.add_link(a, b, link_bandwidth)
    return topo


def big_switch_topology(num_nodes: int, link_bandwidth: float
                        ) -> NetworkTopology:
    """Reference BigSwitchNetworkTopologyGenerator: every node connects to
    one crossbar node (id = num_nodes): a non-blocking InfiniBand fat
    tree between GPU nodes."""
    topo = NetworkTopology(num_nodes + 1)
    for i in range(num_nodes):
        topo.add_link(i, num_nodes, link_bandwidth)
    return topo


class ShortestPathRouting:
    """Reference WeightedShortestPathRoutingStrategy (network.cc:53):
    Dijkstra with edge weight = 1/bandwidth (prefer fat links), memoized."""

    def __init__(self, topo: NetworkTopology):
        self.topo = topo
        self._cache: Dict[Tuple[int, int], Optional[List[int]]] = {}

    def route(self, src: int, dst: int) -> Optional[List[int]]:
        """Node path src..dst inclusive, or None if unreachable."""
        if src == dst:
            return [src]
        key = (src, dst)
        if key in self._cache:
            return self._cache[key]
        dist = {src: 0.0}
        prev: Dict[int, int] = {}
        heap = [(0.0, src)]
        while heap:
            d, u = heapq.heappop(heap)
            if u == dst:
                break
            if d > dist.get(u, float("inf")):
                continue
            for v, bw in self.topo.neighbors(u):
                nd = d + 1.0 / bw
                if nd < dist.get(v, float("inf")):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(heap, (nd, v))
        if dst not in prev and dst != src:
            self._cache[key] = None
            return None
        path = [dst]
        while path[-1] != src:
            path.append(prev[path[-1]])
        path.reverse()
        self._cache[key] = path
        return path

    def bottleneck_bandwidth(self, path: List[int]) -> float:
        return min(self.topo.links[(a, b)]
                   for a, b in zip(path, path[1:])) if len(path) > 1 \
            else float("inf")


class NetworkedMachineModel:
    """Reference NetworkedMachineModel (simulator.h:213-560 family): cost a
    point-to-point transfer as hop latency + bytes / bottleneck bandwidth
    along the routed path."""

    def __init__(self, topo: NetworkTopology,
                 hop_latency_s: float = 1e-6):
        self.topo = topo
        self.routing = ShortestPathRouting(topo)
        self.hop_latency_s = hop_latency_s

    def transfer_time(self, src: int, dst: int, bytes_: float) -> float:
        if src == dst:
            return 0.0
        path = self.routing.route(src, dst)
        if path is None:
            return float("inf")
        hops = len(path) - 1
        bw = self.routing.bottleneck_bandwidth(path)
        return hops * self.hop_latency_s + bytes_ / bw

    def ring_bottleneck_bandwidth(self, nodes: Sequence[int]) -> float:
        """Slowest routed hop of the ring over `nodes` (0.0 when any pair
        is disconnected) — the bandwidth a ring collective is bound by.
        Shared by allreduce_time and the search machine model's
        cross-slice group bandwidth (machine_model._group_bw)."""
        slowest_link = float("inf")
        for a, b in zip(nodes, list(nodes[1:]) + [nodes[0]]):
            path = self.routing.route(a, b)
            if path is None:      # disconnected participants: impossible
                return 0.0
            slowest_link = min(slowest_link,
                               self.routing.bottleneck_bandwidth(path))
        return slowest_link

    def allreduce_time(self, nodes: Sequence[int], bytes_: float) -> float:
        """Ring allreduce along the (routed) ring over `nodes`."""
        n = len(nodes)
        if n <= 1:
            return 0.0
        slowest_link = self.ring_bottleneck_bandwidth(nodes)
        if slowest_link <= 0.0:
            return float("inf")
        return 2.0 * bytes_ * (n - 1) / n / slowest_link \
            + 2 * (n - 1) * self.hop_latency_s
