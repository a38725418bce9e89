"""The port's multichip tier across real cards: one process drives
shards on ``cuda:0`` .. ``cuda:n-1``, as it drives logical shards on
one card. Every case needs two or more CUDA cards; the module is marked
``cuda`` and each test skips without them. Run on a host with several
cards: ``python -m pytest --noconftest -m cuda tests/test_torch_cards.py``
(without the suite's conftest, which sets up JAX).

No JAX here: each case is held to the port's plain versions, its
one-card solve or its ``SpfSolver``, which the CPU files hold to JAX.
Tolerance 0 throughout (int32).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cards():
    """Every visible card, ``cuda:0`` current; skips with fewer than
    two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    torch.cuda.set_device(0)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _planes(card, n, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 1 << 20, (4, 1000), generator=g,
                          dtype=torch.int32).to(card) for _ in range(n)]


def test_shard_kernels_run_on_their_own_card(cards):
    """With ``cuda:0`` current, a kernel whose tensors lie on another
    card launches there (K23 over two members of that card, K21e over
    a residual table there) and equals its plain version; the current
    card is left as it was."""
    from openr_tpu_torch.ops.combine import shard_combine, shard_combine_plain
    from openr_tpu_torch.ops.fabric import fabric_extent, fabric_extent_plain
    from openr_tpu_torch.ops.relax import INF_E

    for i, card in enumerate(cards):
        planes = _planes(card, 2, i)
        want = [t.cpu() for t in planes]
        shard_combine_plain(want, "min")
        launches = shard_combine.launches
        shard_combine(planes, "min")
        assert shard_combine.launches == launches + 1
        assert all(t.device == card for t in planes)
        assert all(torch.equal(t.cpu(), w) for t, w in zip(planes, want))
        res_w = torch.full((64, 8), INF_E, dtype=torch.int32)
        res_w[::3, :5] = 7
        ext = fabric_extent(res_w.to(card))
        assert ext.device == card
        assert torch.equal(ext.cpu(), fabric_extent_plain(res_w))
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_combine_across_cards_is_one_nccl_all_reduce(cards, op):
    """K23 over one member on each card is NCCL's all-reduce: every
    copy equals the plain fold, and the change flag on the first
    member's card is set against a ``ref`` that differs."""
    from openr_tpu_torch.ops.combine import shard_combine, shard_combine_plain

    planes = [_planes(card, 1, 10 + i)[0] for i, card in enumerate(cards)]
    want = [t.cpu() for t in planes]
    shard_combine_plain(want, op)
    ref = planes[0].clone()
    flag = torch.zeros(1, dtype=torch.int32, device=cards[0])
    nccl = shard_combine.nccl
    shard_combine(planes, op, ref=ref, flag=flag)
    assert shard_combine.nccl == nccl + 1
    assert all(torch.equal(t.cpu(), want[0]) for t in planes)
    assert flag.item() == 1


def _lsdb(side):
    from openr_tpu_torch.models import topologies

    adj_dbs, pdbs = topologies.grid(side)
    states, ps = topologies.build_states(adj_dbs, pdbs)
    return adj_dbs, states, ps


def _routes(db):
    return dict(db.unicast_routes.items())


@pytest.mark.parametrize("batch", [1, 0])
def test_solver_tier_across_cards_equals_one_card(cards, batch):
    """``build_route_db`` on the tier over every card (batch 1: the
    'graph' axis spans the cards, so each relaxation's min is an NCCL
    all-reduce; 0: the reference's factoring) equals the one-card
    solve and the oracle, cold and after metric churn, incremental."""
    from openr_tpu_torch import types as ptypes
    from openr_tpu_torch.decision.gpu_solver import GpuSpfSolver
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.ops.combine import shard_combine

    adj_dbs, states, ps = _lsdb(8)
    root = adj_dbs[0].this_node_name
    one = GpuSpfSolver(root, device="cuda:0", incremental_spf=True)
    mc = GpuSpfSolver(root, device="cuda:0", incremental_spf=True,
                      multichip_n_cap_threshold=32, multichip_batch=batch,
                      multichip_devices=cards)
    oracle = SpfSolver(root)
    nccl = shard_combine.nccl
    for bump in (0, 7):
        victim = adj_dbs[1]
        states["0"].update_adjacency_database(ptypes.AdjacencyDatabase(
            this_node_name=victim.this_node_name,
            adjacencies=tuple(ptypes.Adjacency(**{
                **a.__dict__, "metric": a.metric + bump})
                for a in victim.adjacencies), area="0"))
        got = mc.build_route_db(root, states, ps)
        assert mc.last_device_stats.get("multichip"), bump
        assert _routes(got) == _routes(one.build_route_db(root, states, ps))
        assert _routes(got) == _routes(oracle.build_route_db(root, states,
                                                             ps))
    mesh = mc._area_dev["0"].mc_mesh
    assert {d for _, _, d in mesh.shards()} == set(cards)
    if mesh.shape["graph"] > 1:
        assert shard_combine.nccl > nccl


def test_fabric_step_across_cards_passes_the_dry_run(cards):
    """``dryrun_multichip`` over every card: the whole-fabric step on
    the mesh against the host Dijkstra and the oracle's RIBs, and the
    solver's whole-fabric RIBs on that mesh against the oracle."""
    from openr_tpu_torch.entry import dryrun_multichip

    line = dryrun_multichip(len(cards), devices=cards)
    assert line.startswith("dryrun_multichip ok:")
