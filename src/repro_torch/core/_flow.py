"""The graph algorithms the SDC balancer needs, in pure Python.

``repro.core.balance`` solves its min-cost flow and finds its cycles with
networkx, which the port does not depend on.  Where the optimum of that
flow is not unique, the balances and the cycle handed to the floorplan
feedback loop depend on the algorithm's exact pivots and visiting order,
so this module transcribes the networkx 3.6 algorithms the balancer calls,
step for step, over the same node and arc order:

* ``network_simplex`` (``networkx/algorithms/flow/networksimplex.py``):
  the primal network simplex with the artificial-root initial tree and the
  block-search (Dantzig within a block, Bland across blocks) pivot rule;
* ``bellman_ford_path_length`` and ``find_negative_cycle``
  (``networkx/algorithms/shortest_paths/weighted.py``): the SPFA
  Bellman-Ford with its early negative-cycle heuristic, and the walk back
  over the predecessors that extracts the cycle;
* ``find_cycle`` (``networkx/algorithms/cycles.py`` over ``edge_dfs``);
* ``connected_components`` of the undirected view.

A graph is a ``DiGraph``: an insertion-ordered adjacency map, the same
order networkx's ``DiGraph`` keeps, so nodes and arcs are visited in the
same order as there.

Transcribed from NetworkX, which is distributed under the 3-clause BSD
license:

   Copyright (c) 2004-2025, NetworkX Developers
   Aric Hagberg <hagberg@lanl.gov>
   Dan Schult <dschult@colgate.edu>
   Pieter Swart <swart@lanl.gov>
   All rights reserved.

   Redistribution and use in source and binary forms, with or without
   modification, are permitted provided that the following conditions are
   met:

     * Redistributions of source code must retain the above copyright
       notice, this list of conditions and the following disclaimer.

     * Redistributions in binary form must reproduce the above
       copyright notice, this list of conditions and the following
       disclaimer in the documentation and/or other materials provided
       with the distribution.

     * Neither the name of the NetworkX Developers nor the names of its
       contributors may be used to endorse or promote products derived
       from this software without specific prior written permission.

   THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
   "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
   LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
   A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
   OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
   SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT
   LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE,
   DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY
   THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT
   (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE
   OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""
from __future__ import annotations

from collections import deque
from itertools import chain, islice, repeat
from math import ceil, sqrt
from typing import Hashable

INF = float("inf")


class Unbounded(Exception):
    """A negative cycle of infinite capacity (``nx.NetworkXUnbounded``)."""


class NoCycle(Exception):
    """No cycle of the asked kind (``nx.NetworkXError`` from
    ``find_negative_cycle``, ``nx.NetworkXNoCycle`` from ``find_cycle``)."""


class DiGraph:
    """Weighted digraph as networkx's ``DiGraph`` orders it: ``adj[u]`` maps
    each successor to the arc's weight, nodes and successors in the order
    they were first added; re-adding an arc changes its weight in place."""

    def __init__(self) -> None:
        self.adj: dict[Hashable, dict[Hashable, int]] = {}

    def add_node(self, n: Hashable) -> None:
        if n not in self.adj:
            self.adj[n] = {}

    def add_edge(self, u: Hashable, v: Hashable, weight: int) -> None:
        self.add_node(u)
        self.add_node(v)
        self.adj[u][v] = weight

    def edges(self):
        for u, nbrs in self.adj.items():
            for v, w in nbrs.items():
                yield u, v, w


# --------------------------------------------------------------------------
# Network simplex
# --------------------------------------------------------------------------

class _Simplex:
    """The spanning-tree state of the network simplex over numbered nodes
    and arcs (networkx's ``_DataEssentialsAndFunctions``)."""

    def __init__(self, G: DiGraph, demand: dict[Hashable, int]):
        self.node_list = list(G.adj)
        self.node_indices = {u: i for i, u in enumerate(self.node_list)}
        self.node_demands = [demand.get(u, 0) for u in self.node_list]
        self.edge_sources: list[int] = []
        self.edge_targets: list[int] = []
        self.edge_weights: list[int] = []
        self.edge_capacities: list[float] = []
        for u, v, w in G.edges():
            self.edge_sources.append(self.node_indices[u])
            self.edge_targets.append(self.node_indices[v])
            self.edge_capacities.append(INF)
            self.edge_weights.append(w)
        self.edge_count = len(self.edge_sources)

    def initialize_spanning_tree(self, n: int, faux_inf: int) -> None:
        self.edge_flow = list(chain(repeat(0, self.edge_count),
                                    (abs(d) for d in self.node_demands)))
        self.node_potentials = [faux_inf if d <= 0 else -faux_inf
                                for d in self.node_demands]
        self.parent = list(chain(repeat(-1, n), [None]))
        self.parent_edge = list(range(self.edge_count, self.edge_count + n))
        self.subtree_size = list(chain(repeat(1, n), [n + 1]))
        self.next_node_dft = list(chain(range(1, n), [-1, 0]))
        self.prev_node_dft = list(range(-1, n))
        self.last_descendent_dft = list(chain(range(n), [n - 1]))

    def find_apex(self, p, q):
        """The lowest common ancestor of nodes p and q in the tree."""
        size_p = self.subtree_size[p]
        size_q = self.subtree_size[q]
        while True:
            while size_p < size_q:
                p = self.parent[p]
                size_p = self.subtree_size[p]
            while size_p > size_q:
                q = self.parent[q]
                size_q = self.subtree_size[q]
            if size_p == size_q:
                if p != q:
                    p = self.parent[p]
                    size_p = self.subtree_size[p]
                    q = self.parent[q]
                    size_q = self.subtree_size[q]
                else:
                    return p

    def trace_path(self, p, w):
        """Nodes and arcs on the tree path from p up to its ancestor w."""
        Wn = [p]
        We = []
        while p != w:
            We.append(self.parent_edge[p])
            p = self.parent[p]
            Wn.append(p)
        return Wn, We

    def find_cycle(self, i, p, q):
        """Nodes and arcs of the cycle arc i == (p, q) closes in the tree,
        oriented from p to q."""
        w = self.find_apex(p, q)
        Wn, We = self.trace_path(p, w)
        Wn.reverse()
        We.reverse()
        if We != [i]:
            We.append(i)
        WnR, WeR = self.trace_path(q, w)
        del WnR[-1]
        Wn += WnR
        We += WeR
        return Wn, We

    def augment_flow(self, Wn, We, f):
        for i, p in zip(We, Wn):
            if self.edge_sources[i] == p:
                self.edge_flow[i] += f
            else:
                self.edge_flow[i] -= f

    def trace_subtree(self, p):
        yield p
        last = self.last_descendent_dft[p]
        while p != last:
            p = self.next_node_dft[p]
            yield p

    def remove_edge(self, s, t):
        """Remove the tree arc (s, t), where parent[t] == s."""
        size_t = self.subtree_size[t]
        prev_t = self.prev_node_dft[t]
        last_t = self.last_descendent_dft[t]
        next_last_t = self.next_node_dft[last_t]
        self.parent[t] = None
        self.parent_edge[t] = None
        self.next_node_dft[prev_t] = next_last_t
        self.prev_node_dft[next_last_t] = prev_t
        self.next_node_dft[last_t] = t
        self.prev_node_dft[t] = last_t
        while s is not None:
            self.subtree_size[s] -= size_t
            if self.last_descendent_dft[s] == last_t:
                self.last_descendent_dft[s] = prev_t
            s = self.parent[s]

    def make_root(self, q):
        """Make q the root of the subtree that holds it."""
        ancestors = []
        while q is not None:
            ancestors.append(q)
            q = self.parent[q]
        ancestors.reverse()
        for p, q in zip(ancestors, islice(ancestors, 1, None)):
            size_p = self.subtree_size[p]
            last_p = self.last_descendent_dft[p]
            prev_q = self.prev_node_dft[q]
            last_q = self.last_descendent_dft[q]
            next_last_q = self.next_node_dft[last_q]
            self.parent[p] = q
            self.parent[q] = None
            self.parent_edge[p] = self.parent_edge[q]
            self.parent_edge[q] = None
            self.subtree_size[p] = size_p - self.subtree_size[q]
            self.subtree_size[q] = size_p
            self.next_node_dft[prev_q] = next_last_q
            self.prev_node_dft[next_last_q] = prev_q
            self.next_node_dft[last_q] = q
            self.prev_node_dft[q] = last_q
            if last_p == last_q:
                self.last_descendent_dft[p] = prev_q
                last_p = prev_q
            self.prev_node_dft[p] = last_q
            self.next_node_dft[last_q] = p
            self.next_node_dft[last_p] = q
            self.prev_node_dft[q] = last_p
            self.last_descendent_dft[q] = last_p

    def add_edge(self, i, p, q):
        """Add the tree arc i == (p, q), where q roots a subtree."""
        last_p = self.last_descendent_dft[p]
        next_last_p = self.next_node_dft[last_p]
        size_q = self.subtree_size[q]
        last_q = self.last_descendent_dft[q]
        self.parent[q] = p
        self.parent_edge[q] = i
        self.next_node_dft[last_p] = q
        self.prev_node_dft[q] = last_p
        self.prev_node_dft[next_last_p] = last_q
        self.next_node_dft[last_q] = next_last_p
        while p is not None:
            self.subtree_size[p] += size_q
            if self.last_descendent_dft[p] == last_p:
                self.last_descendent_dft[p] = last_q
            p = self.parent[p]

    def update_potentials(self, i, p, q):
        """Shift the potentials of the subtree under q, joined to its parent
        p by arc i."""
        if q == self.edge_targets[i]:
            d = self.node_potentials[p] - self.edge_weights[i] \
                - self.node_potentials[q]
        else:
            d = self.node_potentials[p] + self.edge_weights[i] \
                - self.node_potentials[q]
        for q in self.trace_subtree(q):
            self.node_potentials[q] += d

    def reduced_cost(self, i):
        c = (self.edge_weights[i] - self.node_potentials[self.edge_sources[i]]
             + self.node_potentials[self.edge_targets[i]])
        return c if self.edge_flow[i] == 0 else -c

    def find_entering_edges(self):
        """Entering arcs: Dantzig's rule within blocks of ceil(sqrt(m))
        arcs, taken cyclically; stops after a full round with none."""
        if self.edge_count == 0:
            return
        B = int(ceil(sqrt(self.edge_count)))
        M = (self.edge_count + B - 1) // B
        m = 0
        f = 0
        while m < M:
            last = f + B
            if last <= self.edge_count:
                edges = range(f, last)
            else:
                last -= self.edge_count
                edges = chain(range(f, self.edge_count), range(last))
            f = last
            i = min(edges, key=self.reduced_cost)
            c = self.reduced_cost(i)
            if c >= 0:
                m += 1
            else:
                if self.edge_flow[i] == 0:
                    p = self.edge_sources[i]
                    q = self.edge_targets[i]
                else:
                    p = self.edge_targets[i]
                    q = self.edge_sources[i]
                yield i, p, q
                m = 0

    def residual_capacity(self, i, p):
        return (self.edge_capacities[i] - self.edge_flow[i]
                if self.edge_sources[i] == p else self.edge_flow[i])

    def find_leaving_edge(self, Wn, We):
        j, s = min(zip(reversed(We), reversed(Wn)),
                   key=lambda i_p: self.residual_capacity(*i_p))
        t = self.edge_targets[j] if self.edge_sources[j] == s \
            else self.edge_sources[j]
        return j, s, t


def network_simplex(G: DiGraph, demand: dict[Hashable, int]):
    """Min-cost flow meeting ``demand`` (networkx's sign: in - out, summing
    to 0) over arcs of infinite capacity costing their weight a unit; the
    balancer's flow graph has no self-loop and always a feasible flow.
    Returns ``(flow_cost, flow)`` with ``flow[u][v]`` the flow on arc
    (u, v); raises ``Unbounded`` where networkx does."""
    D = _Simplex(G, demand)

    # the artificial root -1, joined to every node by an arc of faux-infinite
    # capacity and cost that meets its demand: the first, strongly feasible
    # spanning tree
    for i, d in enumerate(D.node_demands):
        if d > 0:
            D.edge_sources.append(-1)
            D.edge_targets.append(i)
        else:
            D.edge_sources.append(i)
            D.edge_targets.append(-1)
    faux_inf = 3 * max(0, sum(abs(w) for w in D.edge_weights),
                       sum(abs(d) for d in D.node_demands)) or 1
    n = len(D.node_list)
    D.edge_weights.extend(repeat(faux_inf, n))
    D.edge_capacities.extend(repeat(faux_inf, n))
    D.initialize_spanning_tree(n, faux_inf)

    for i, p, q in D.find_entering_edges():
        Wn, We = D.find_cycle(i, p, q)
        j, s, t = D.find_leaving_edge(Wn, We)
        D.augment_flow(Wn, We, D.residual_capacity(j, s))
        if i != j:
            if D.parent[t] != s:
                s, t = t, s
            if We.index(i) > We.index(j):
                p, q = q, p
            D.remove_edge(s, t)
            D.make_root(q)
            D.add_edge(i, p, q)
            D.update_potentials(i, p, q)

    if any(D.edge_flow[i] * 2 >= faux_inf for i in range(D.edge_count)):
        raise Unbounded("negative cycle with infinite capacity found")

    del D.edge_flow[D.edge_count:]
    flow_cost = sum(w * x for w, x in zip(D.edge_weights, D.edge_flow))
    flow: dict[Hashable, dict[Hashable, int]] = {u: {} for u in D.node_list}
    for s, t, x in zip(D.edge_sources, D.edge_targets, D.edge_flow):
        flow[D.node_list[s]][D.node_list[t]] = x
    return flow_cost, flow


# --------------------------------------------------------------------------
# Bellman-Ford (SPFA) and cycles
# --------------------------------------------------------------------------

def _inner_bellman_ford(G: DiGraph, sources, pred, dist):
    """The SPFA relaxation loop with networkx's early negative-cycle
    heuristic.  Returns a node on a negative cycle, or None."""
    nonexistent_edge = (None, None)
    pred_edge = {v: None for v in sources}
    recent_update = {v: nonexistent_edge for v in sources}
    n = len(G.adj)
    count: dict = {}
    q = deque(sources)
    in_q = set(sources)
    while q:
        u = q.popleft()
        in_q.remove(u)
        # skip the relaxations while a predecessor of u is queued
        if all(pred_u not in in_q for pred_u in pred[u]):
            dist_u = dist[u]
            for v, w in G.adj[u].items():
                dist_v = dist_u + w
                if dist_v < dist.get(v, INF):
                    # v already on u's update path: a negative cycle
                    if v in recent_update[u]:
                        pred[v].append(u)
                        return v
                    if v in pred_edge and pred_edge[v] == u:
                        recent_update[v] = recent_update[u]
                    else:
                        recent_update[v] = (u, v)
                    if v not in in_q:
                        q.append(v)
                        in_q.add(v)
                        count_v = count.get(v, 0) + 1
                        if count_v == n:
                            return v
                        count[v] = count_v
                    dist[v] = dist_v
                    pred[v] = [u]
                    pred_edge[v] = u
                elif dist.get(v) is not None and dist_v == dist.get(v):
                    pred[v].append(u)
    return None


def bellman_ford_path_length(G: DiGraph, source) -> dict:
    """Shortest distances from ``source``
    (``nx.single_source_bellman_ford_path_length``); raises ``Unbounded``
    on a negative cycle."""
    dist = {source: 0}
    if _inner_bellman_ford(G, [source], {source: []}, dist) is not None:
        raise Unbounded("Negative cycle detected.")
    return dist


def find_negative_cycle(G: DiGraph, source) -> list:
    """A negative cycle reachable from ``source``, as a node list whose last
    node repeats the first (``nx.find_negative_cycle``); raises ``NoCycle``
    when there is none."""
    pred = {source: []}
    v = _inner_bellman_ford(G, [source], pred, {source: 0})
    if v is None:
        raise NoCycle("No negative cycles detected.")
    neg_cycle = []
    stack = [(v, list(pred[v]))]
    seen = {v}
    while stack:
        node, preds = stack[-1]
        if v in preds:
            neg_cycle.extend([node, v])
            return list(reversed(neg_cycle))
        if preds:
            nbr = preds.pop()
            if nbr not in seen:
                stack.append((nbr, list(pred[nbr])))
                neg_cycle.append(node)
                seen.add(nbr)
        else:
            stack.pop()
            if not neg_cycle:
                raise Unbounded("Negative cycle is detected but not found")
            neg_cycle.pop()
    raise Unbounded("negative cycle detected but not identified")


def find_cycle(G: DiGraph) -> list[tuple]:
    """The arcs of a directed cycle met by depth-first search over the arcs
    (``nx.find_cycle`` with no source); raises ``NoCycle``."""
    explored: set = set()
    cycle: list[tuple] = []
    final_node = None
    for start_node in G.adj:
        if start_node in explored:
            continue
        edges: list[tuple] = []
        seen = {start_node}
        active_nodes = {start_node}
        previous_head = None
        for tail, head in _edge_dfs(G, start_node):
            if head in explored:
                continue
            if previous_head is not None and tail != previous_head:
                # backtracked: pop to the arc whose head is this tail
                while True:
                    try:
                        popped = edges.pop()
                    except IndexError:
                        edges = []
                        active_nodes = {tail}
                        break
                    else:
                        active_nodes.remove(popped[1])
                    if edges and tail == edges[-1][1]:
                        break
            edges.append((tail, head))
            if head in active_nodes:
                cycle.extend(edges)
                final_node = head
                break
            seen.add(head)
            active_nodes.add(head)
            previous_head = head
        if cycle:
            break
        explored.update(seen)
    else:
        raise NoCycle("No cycle found.")
    for i, (tail, _head) in enumerate(cycle):
        if tail == final_node:
            break
    return cycle[i:]


def _edge_dfs(G: DiGraph, start_node):
    """Every arc reachable from ``start_node``, depth first
    (``nx.edge_dfs``)."""
    visited_edges: set = set()
    visited_nodes: set = set()
    edges: dict = {}
    stack = [start_node]
    while stack:
        current = stack[-1]
        if current not in visited_nodes:
            edges[current] = iter([(current, v) for v in G.adj[current]])
            visited_nodes.add(current)
        try:
            edge = next(edges[current])
        except StopIteration:
            stack.pop()
        else:
            if edge not in visited_edges:
                visited_edges.add(edge)
                stack.append(edge[1])
                yield edge


def connected_components(nodes, pairs) -> list[set]:
    """The components of the undirected graph on ``nodes`` with an edge for
    each pair."""
    nbrs: dict = {n: [] for n in nodes}
    for a, b in pairs:
        nbrs[a].append(b)
        nbrs[b].append(a)
    seen: set = set()
    comps = []
    for n in nbrs:
        if n in seen:
            continue
        comp, todo = {n}, [n]
        while todo:
            for m in nbrs[todo.pop()]:
                if m not in comp:
                    comp.add(m)
                    todo.append(m)
        seen |= comp
        comps.append(comp)
    return comps
