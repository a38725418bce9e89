"""Graft entry point of the port (the counterpart of the JAX package's
``__graft_entry__.entry``).

``entry(device)`` returns ``(fn, example_args)``: ``fn`` is the
single-card forward step of the legacy pipeline — K18 distances from
the root, K19 first-hop slot masks, K20 best-route selection
(``gpu_solver.legacy_pipeline``) — and ``example_args`` its 13 inputs
for a generated 8 x 8 grid, vantage ``node-0-0``, as tensors on
``device``. ``fn(*example_args)`` returns ``(metric [P], s3 [P, A],
nh_mask [P, D], has_route [P])``, as the JAX forward step does.

The multichip dry run (``__graft_entry__.dryrun_multichip``) is not
ported yet: it needs the cross-card fabric step.
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
