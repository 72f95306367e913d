"""The gather kernels' plan and sorting networks, on the CPU.

``stage_plan`` cuts a neighbour table into groups whose rows a block of the
CUDA kernels stages once; ``share_sorts`` lists each group's targets so
that targets with equal member sets share one sort.  The kernels run only
on the card (``tests/test_torch_cuda.py``), so here plain models of them,
gathering through the plan and sharing sorts as the kernels do, are held
bit-equal to the plain versions ``gather_mix_ref`` and
``gather_robust_mix_ref``.  The sorting networks of
``csrc/sort_networks.cuh`` are read from the header and checked to sort.
"""
import itertools
import re

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro_torch.core.mixing import _gather_weights, make_mixer  # noqa: E402
from repro_torch.core.participation import masked_combination  # noqa: E402
from repro_torch.core.topology import (make_topology,  # noqa: E402
                                       metropolis_weights)
from repro_torch.kernels import gather_mix as gm  # noqa: E402
from repro_torch.kernels import gather_robust_mix as grm  # noqa: E402
from repro_torch.kernels.build import CSRC  # noqa: E402
from repro_torch.kernels.ref import (gather_mix_ref,  # noqa: E402
                                     gather_robust_mix_ref)

TABLES = [(kind, K, kw) for K in (8, 12, 16, 1024)
          for kind, kw in (("ring", {}), ("ring", {"hops": 2}),
                           ("grid", {}), ("fedavg", {}))]


def _table(kind, K, kw):
    return torch.as_tensor(make_topology(kind, K, **kw).neighbor_table()[0])


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,K,kw", TABLES)
def test_stage_plan_maps_every_slot_to_its_row(kind, K, kw):
    idx = _table(kind, K, kw)
    D = idx.shape[1]
    plan = gm.stage_plan(idx)
    if kind == "fedavg" and K > gm.MAX_STAGED_ROWS:
        # D = K rows per target: no group stages them
        assert plan.route == "target" and plan.rows is None
        return
    assert plan.route == "group"
    R, U = plan.group, plan.staged_rows
    rows, slot = plan.rows.long(), plan.slot.long()
    G = -(-K // R)
    assert 1 <= R <= gm.MAX_GROUP and R * D <= gm.MAX_GROUP_SLOTS
    assert rows.shape == (G, U) and slot.shape == (K, D)
    assert 1 <= U <= gm.MAX_STAGED_ROWS
    # the stated bound of each table
    if kind == "ring":
        assert U <= R + 2 * kw.get("hops", 1)
    elif kind == "grid":
        assert U <= 3 * R + 2
    else:
        assert (R, U) == (K, K)
    for g in range(G):
        targets = range(g * R, min(K, (g + 1) * R))
        union = sorted({int(r) for k in targets for r in idx[k]})
        real = rows[g][rows[g] >= 0].tolist()
        # the group's distinct rows, ascending, then -1 padding
        assert real == union
        assert (rows[g][len(real):] == -1).all()
        for k in targets:
            assert (slot[k] < len(real)).all()
            assert torch.equal(rows[g][slot[k]], idx[k].long())


def test_stage_plan_reads_fewest_rows_per_target():
    # the training ring and serving's FedAvg stage every row once, the
    # large ring almost once
    for kind, K, kw, want in (("ring", 12, {}, (12, 12)),
                              ("fedavg", 8, {}, (8, 8)),
                              ("ring", 1024, {}, (14, 16))):
        plan = gm.stage_plan(_table(kind, K, kw))
        assert (plan.group, plan.staged_rows) == want, kind


# ---------------------------------------------------------------------------
# (b) plain models of the kernels through the plan
# ---------------------------------------------------------------------------

def _clique_draw(K):
    """A realized matrix on FedAvg's support in which some targets share a
    member set and others do not: cliques {0..3}, {4, 5}, then singles."""
    adj = np.zeros((K, K), dtype=bool)
    adj[:4, :4] = True
    adj[4:6, 4:6] = True
    return metropolis_weights(adj | np.eye(K, dtype=bool))


def _draws(topo, rng):
    K = topo.num_agents
    up = np.triu(rng.random((K, K)) >= 0.3, 1)
    drop = metropolis_weights(topo.adjacency & (up | up.T)
                              | np.eye(K, dtype=bool))
    out = [("ones", topo.A, np.ones(K)), ("zeros", topo.A, np.zeros(K)),
           ("random", topo.A, (rng.random(K) < 0.6) * 1.0),
           ("link drops", drop, (rng.random(K) < 0.8) * 1.0)]
    if topo.name.startswith("fedavg"):
        out.append(("cliques", _clique_draw(K), np.ones(K)))
    return out


def _operands(topo, A_np, mask_np, robust):
    A = torch.as_tensor(A_np, dtype=torch.float32)
    m = torch.as_tensor(mask_np, dtype=torch.float32)
    mixer = make_mixer(robust, topo, trim=1, scope="neighborhood",
                       gather="table", device="cpu")
    idx, member, S = mixer._gather_members(m, A)
    idx_t, valid = mixer._table.on("cpu")
    gw = _gather_weights(masked_combination(A, m), idx_t, valid)
    return (idx.to(torch.int32), gw,
            (idx.to(torch.int32), member.float(),
             mixer._slot_weights(S, idx.shape[1]), m))


def _staged_rows(plan, idx):
    """(K, D) the row each slot reads through the plan."""
    if plan.group == 0:
        return idx.long()
    g = torch.arange(idx.shape[0]) // plan.group
    return plan.rows.long()[g[:, None], plan.slot.long()]


def gather_through_plan(plan, idx, gw, W):
    """gather_mix as the kernel reads it: every slot's row through its
    group's staged rows, then the plain version's contraction."""
    return torch.einsum("kd,kdm->km", gw.float(),
                        W.float()[_staged_rows(plan, idx)])


def robust_through_plan(plan, idx, member, wslot, active, W):
    """gather_robust_mix as the kernel walks it: each group's targets in
    ``order``; a leader sorts its members' staged values, the targets after
    it reuse that sort, a target flagged SAME the previous target's weights
    too (so its result); inactive targets keep their own staged row.  The
    contraction is the plain version's."""
    if plan.group == 0:
        return gather_robust_mix_ref(idx, member, wslot, active, W)
    K, D = idx.shape
    x = W.float()
    rows = _staged_rows(plan, idx)
    srt = torch.zeros((K, D, x.shape[1]))
    used = wslot.float().clone()
    held = prev = None
    for e in plan.order.tolist():
        k = e & grm.TARGET
        if k >= K or e & grm.INACTIVE:
            continue
        if e & grm.LEADER:
            vals = torch.where(member[k][:, None] > 0, x[rows[k]],
                               torch.tensor(float("inf")))
            held = torch.sort(vals, dim=0).values
        if e & grm.SAME:
            used[k] = used[prev]
        srt[k] = held
        prev = k
    wb = used[:, :, None]
    agg = (torch.where(wb > 0, srt, torch.zeros(())) * wb).sum(dim=1)
    return torch.where(active.reshape(-1, 1) > 0, agg, x[rows[:, 0]])


def _check_walk(plan, idx, member, wslot, active):
    """The walk the kernel takes: every target once; per group the active
    targets set by set, each set led by its first target, then the
    inactive ones; a leader for every distinct member set; SAME exactly
    where a follower's weights equal the previous target's."""
    K = idx.shape[0]
    R = plan.group
    order = plan.order.tolist()
    key = [tuple(sorted(int(r) for r, m in zip(idx[k], member[k]) if m > 0))
           for k in range(K)]
    assert sorted(e & grm.TARGET for e in order) == list(
        range(len(order)))
    for g in range(len(order) // R):
        walk = order[g * R:(g + 1) * R]
        targets = [e & grm.TARGET for e in walk]
        real = [k for k in targets if k < K]
        assert real == targets[:len(real)]
        live = [k for k in real if active[k] > 0]
        assert real[:len(live)] == live
        assert all(walk[i] & grm.INACTIVE for i in range(len(live), R))
        sets = []
        for i, k in enumerate(live):
            lead = bool(walk[i] & grm.LEADER)
            assert lead == (i == 0 or key[k] != key[live[i - 1]])
            if lead:
                assert key[k] not in sets
                sets.append(key[k])
            repeat = not lead and torch.equal(wslot[k], wslot[live[i - 1]])
            assert bool(walk[i] & grm.SAME) == repeat
        assert len(sets) == len({key[k] for k in live})


@pytest.mark.parametrize("kind,K,kw",
                         [t for t in TABLES if t[1] <= 16]
                         + [("ring", 1024, {}), ("grid", 1024, {}),
                            ("fedavg", 20, {})])
def test_plain_models_through_the_plan_are_bit_equal(kind, K, kw):
    topo = make_topology(kind, K, **kw)
    rng = np.random.default_rng(K)
    M = 37 if K <= 20 else 3
    W = torch.as_tensor(rng.standard_normal((K, M)), dtype=torch.float32)
    for label, A_np, mask in _draws(topo, rng):
        for robust in ("trimmed_mean", "median"):
            idx, gw, rob = _operands(topo, A_np, mask, robust)
            plan = gm.stage_plan(idx)
            assert torch.equal(gather_through_plan(plan, idx, gw, W),
                               gather_mix_ref(idx, gw, W)), label
            shared = grm.share_sorts(plan, *rob)
            if shared.group:
                _check_walk(shared, *rob)
            got = robust_through_plan(shared, *rob, W)
            assert torch.equal(got, gather_robust_mix_ref(*rob, W)), (
                label, robust)
            dead = rob[3] == 0
            assert torch.equal(got[dead], W[dead]), label


def test_share_sorts_shares_where_member_sets_are_equal():
    topo = make_topology("fedavg", 8)
    # all eight agents in one set: one sort, one result; cliques {0..3},
    # {4, 5}, {6}, {7}: four sorts, four results taken over
    for A_np, leaders, same in ((topo.A, 1, 7), (_clique_draw(8), 4, 4)):
        idx, _, rob = _operands(topo, A_np, np.ones(8), "trimmed_mean")
        order = grm.share_sorts(gm.stage_plan(idx), *rob).order.tolist()
        assert sum(bool(e & grm.LEADER) for e in order) == leaders
        assert sum(bool(e & grm.SAME) for e in order) == same


def test_check_plan_refuses_a_plan_of_another_table():
    idx = _table("ring", 12, {})
    plan = gm.stage_plan(idx)
    with pytest.raises(ValueError, match="plan slot"):
        gm.check_plan(plan.group, plan.rows, plan.slot[:6], idx)
    with pytest.raises(ValueError, match="int32"):
        gm.check_plan(plan.group, plan.rows.long(), plan.slot, idx)
    with pytest.raises(ValueError, match="one-target route"):
        gm.check_plan(0, plan.rows, None, idx)
    with pytest.raises(ValueError, match="plan order"):
        gm.check_plan(plan.group, plan.rows, plan.slot, idx, order=None)


# ---------------------------------------------------------------------------
# (c) the sorting networks
# ---------------------------------------------------------------------------

def _networks():
    text = (CSRC / "sort_networks.cuh").read_text()
    nets = {}
    for entry in re.split(r"^SORT_NET\(", text, flags=re.M)[1:]:
        P, N = re.match(r"(\d+), (\d+),", entry).groups()
        pairs = [(int(a), int(b))
                 for a, b in re.findall(r"CX\((\d+), (\d+)\)", entry)]
        assert len(pairs) == int(N)
        nets[int(P)] = pairs
    return nets


def _apply(pairs, v):
    """Run a network over the rows of ``v`` (width, n), as the kernel's
    compare-exchange does (min to the lower slot)."""
    v = v.clone()
    for i, j in pairs:
        lo, hi = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
        v[i], v[j] = lo, hi
    return v


def test_network_table_covers_every_width():
    nets = _networks()
    assert sorted(nets) == list(range(1, 17)) + [24, 32]
    # the fewest compare-exchanges at the path's widths
    assert [len(nets[P]) for P in (3, 5, 8)] == [3, 9, 19]
    for P, pairs in nets.items():
        assert all(0 <= i < j < P for i, j in pairs), P


@pytest.mark.parametrize("P", range(1, 17))
def test_networks_sort_every_0_1_input(P):
    pairs = _networks()[P]
    bits = torch.tensor(list(itertools.product((0.0, 1.0), repeat=P)),
                        dtype=torch.float32).T                 # (P, 2^P)
    out = _apply(pairs, bits)
    assert torch.equal(out, torch.sort(bits, dim=0).values), P


@pytest.mark.parametrize("P", [24, 32])
def test_wide_networks_sort_like_torch(P):
    rng = np.random.default_rng(P)
    v = rng.standard_normal((P, 4096)).astype(np.float32)
    v[:, :1024] = np.round(v[:, :1024])                    # ties
    v[rng.random((P, 4096)) < 0.1] = np.inf
    v[rng.random((P, 4096)) < 0.05] = -np.inf
    v = torch.from_numpy(v)
    for D in (P - 7, P):                    # padded with +inf past D
        x = torch.cat([v[:D], torch.full((P - D, v.shape[1]),
                                         float("inf"))])
        assert torch.equal(_apply(_networks()[P], x),
                           torch.sort(x, dim=0).values), (P, D)
