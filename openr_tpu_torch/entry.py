"""Graft entry point of the port (the counterpart of the JAX package's
``__graft_entry__.entry``).

``entry(device)`` returns ``(fn, example_args)``: ``fn`` is the
single-card forward step of the legacy pipeline — K18 distances from
the root, K19 first-hop slot masks, K20 best-route selection
(``gpu_solver.legacy_pipeline``) — and ``example_args`` its 13 inputs
for a generated 8 x 8 grid, vantage ``node-0-0``, as tensors on
``device``. ``fn(*example_args)`` returns ``(metric [P], s3 [P, A],
nh_mask [P, D], has_route [P])``, as the JAX forward step does.

``dryrun_multichip(n_devices)`` is the port of
``__graft_entry__.dryrun_multichip``: the whole-fabric step over an
n-device ('batch', 'graph') mesh on a grid(32), held to the reference's
three oracles. Where the reference forces n virtual CPU devices, the
port lays n logical shards on one device (``device``) unless
``devices`` names the cards.
"""

from __future__ import annotations

from openr_tpu_torch.decision.gpu_solver import legacy_pipeline, resolve_device
from openr_tpu_torch.ops.legacy import ell_tensors, to_device


def _example_problem(grid_n: int = 8):
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops.csr import build_ell, build_prefix_matrix

    adj_dbs, prefix_dbs = topologies.grid(grid_n)
    link_states, prefix_state = topologies.build_states(adj_dbs, prefix_dbs)
    graph = build_ell(link_states["0"])
    matrix = build_prefix_matrix(prefix_state, graph.node_index, "0")
    root_idx = graph.node_index["node-0-0"]
    root_nbr, root_w, root_up, _links = graph.out_table(root_idx)
    return graph, matrix, root_idx, (root_nbr, root_w, root_up)


def forward(in_nbr, in_w, in_up, node_over, root, r_nbr, r_w, r_up,
            ann_node, ann_valid, path_pref, source_pref, dist_adv) -> tuple:
    """The forward step: ``legacy_pipeline`` without its distances."""
    return legacy_pipeline(
        in_nbr, in_w, in_up, node_over, root, r_nbr, r_w, r_up, ann_node,
        ann_valid, path_pref, source_pref, dist_adv,
    )[1:]


def entry(device="cuda"):
    """-> (fn, example_args): the full forward step on one card."""
    dev = resolve_device(device)
    graph, matrix, root_idx, root_table = _example_problem()
    example_args = (
        *ell_tensors(graph, dev),
        int(root_idx),
        *to_device(dev, *root_table),
        *to_device(dev, matrix.ann_node, matrix.ann_valid, matrix.path_pref,
                   matrix.source_pref, matrix.dist_adv),
    )
    return forward, example_args


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> str:
    """Shard the whole-fabric step over an ``n_devices`` mesh
    (``parallel/sharding.make_mesh``: n logical shards on ``device``, or
    the cards ``devices`` names) and check it, on grid(32) (1,024 nodes,
    one loopback prefix each) from ``2 * batch`` roots spread over the
    grid: (1) every root's distances to every node against the host
    Dijkstra, (2) every prefix's metric and first-hop neighbours against
    the CPU oracle's RIB from each vantage, (3)
    ``GpuSpfSolver.build_fabric_route_dbs`` on the mesh, LFA on, RIB for
    RIB against the oracle. Prints and returns the reference's summary
    line, followed by the shards' devices."""
    import numpy as np

    from openr_tpu_torch.decision.gpu_solver import GpuSpfSolver
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops.csr import build_prefix_matrix
    from openr_tpu_torch.ops.edgeplan import INF32E, build_plan
    from openr_tpu_torch.parallel.sharding import make_mesh, sharded_fabric_step

    if devices is None:
        devices = [resolve_device(device)] * n_devices
    else:
        devices = [resolve_device(d) for d in devices]
    grid_n = 32
    adj_dbs, prefix_dbs = topologies.grid(grid_n, node_labels=False)
    link_states, prefix_state = topologies.build_states(adj_dbs, prefix_dbs)
    ls = link_states["0"]
    plan = build_plan(ls)
    matrix = build_prefix_matrix(prefix_state, plan.node_index, "0")

    mesh = make_mesh(n_devices, devices=devices)
    n_roots = mesh.shape["batch"] * 2  # a multiple of the batch axis
    root_names = [
        plan.node_names[(i * plan.n_nodes) // n_roots] for i in range(n_roots)
    ]
    roots = np.array([plan.node_index[nm] for nm in root_names], np.int32)
    outs = [plan.out_links(ls, nm) for nm in root_names]
    d_cap = max(o[0].shape[0] for o in outs)
    out_nbr = np.full((n_roots, d_cap), -1, np.int32)
    out_w = np.full((n_roots, d_cap), int(INF32E), np.int32)
    links_per_root = []
    for i, (nbr, w, links) in enumerate(outs):
        out_nbr[i, : nbr.shape[0]] = nbr
        out_w[i, : w.shape[0]] = w
        links_per_root.append(links)
    # the grid's diameter 2 * (grid_n - 1) relaxations, UNROLL a trip, x2
    n_trips = 2 * (-(-(2 * (grid_n - 1) + 1) // 8) + 1)

    dist, metric, _s3, nh_mask, _ls, _lm = sharded_fabric_step(
        mesh, plan, matrix, roots, out_nbr, out_w, n_trips
    )
    dist, metric, nh_mask = (t.cpu().numpy() for t in (dist, metric, nh_mask))
    assert dist.shape == (n_roots, plan.n_cap), dist.shape

    # oracle 1: distances against the host Dijkstra, every root x node
    for i, root in enumerate(root_names):
        spf = ls.run_spf(root)
        for v, name in enumerate(plan.node_names):
            expect = spf[name].metric if name in spf else int(INF32E)
            assert int(dist[i, v]) == expect, (root, name)

    # oracle 2: each prefix's metric and first-hop neighbours against the
    # CPU SpfSolver's RIB from each vantage
    row_of = {p: r for r, p in enumerate(matrix.prefix_list)}
    n_routes = 0
    for i, root in enumerate(root_names):
        cpu_db = SpfSolver(root).build_route_db(root, link_states,
                                                prefix_state)
        links = links_per_root[i]
        for pfx, route in cpu_db.unicast_routes.items():
            r = row_of[pfx]
            assert int(metric[i, r]) == route.igp_cost, (root, pfx)
            got = {
                links[d].other_node(root)
                for d in np.flatnonzero(nh_mask[i, r, : len(links)])
            }
            want = {nh.neighbor_node_name for nh in route.nexthops}
            assert got == want, (root, pfx, got, want)
            n_routes += 1
    assert n_routes == n_roots * (plan.n_nodes - 1), n_routes

    # oracle 3: the solver's fabric API on the mesh returns full RIBs
    # equal to the per-vantage CPU oracle's, LFA backups included
    solver = GpuSpfSolver(root_names[0], device=mesh.first, enable_lfa=True)
    fabric_dbs = solver.build_fabric_route_dbs(
        root_names, link_states, prefix_state, mesh=mesh
    )
    n_fabric = 0
    for root in root_names:
        cpu_db = SpfSolver(root, enable_lfa=True).build_route_db(
            root, link_states, prefix_state
        )
        got_db = fabric_dbs[root]
        assert got_db.unicast_routes == cpu_db.unicast_routes, root
        n_fabric += len(got_db.unicast_routes)
    line = (
        f"dryrun_multichip ok: mesh={dict(mesh.shape)} roots={n_roots} "
        f"nodes={plan.n_nodes} routes_verified={n_routes} "
        f"fabric_rib_routes_verified={n_fabric} (incl. LFA) "
        f"dist+metric+nexthops+full-RIB verified vs CPU oracle; shards on "
        f"{[str(d) for row in mesh.devices for d in row]}"
    )
    print(line)
    return line
