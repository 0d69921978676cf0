"""GNN minibatch training on RidgeWalker-sampled blocks, on the PyTorch
port (the counterpart of ``examples/gnn_neighbor_sampling.py``).

The fanout neighbor sampler (``graph/sampling_service.py`` — one-hop
bounded random walks on the stateless-sampling substrate) feeds PNA
minibatch training, the ``minibatch_lg`` regime at a small scale.  PNA's
row gathers run on the embedding-bag kernel and its sums on the
segment-sum kernel, whose launches the last line counts.

  PYTHONPATH=src python examples/torch_gnn_neighbor_sampling.py   # card
  PYTHONPATH=src python examples/torch_gnn_neighbor_sampling.py \\
      --device cpu --scale 9 --iters 20
"""
import argparse

import numpy as np
import torch

from repro_torch.core.rng import seeded_generator
from repro_torch.graph import make_dataset
from repro_torch.graph.sampling_service import block_union_graph, sample_blocks
from repro_torch.kernels.embedding_bag import LAUNCHES as BAG
from repro_torch.kernels.segment_sum import LAUNCHES as SEG
from repro_torch.launch.train import make_grad_step
from repro_torch.models.gnn import pna
from repro_torch.optim import adamw

D_FEAT, N_CLASSES = 32, 7
FANOUTS = (10, 5)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=12, help="RMAT scale")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)

    g = make_dataset("WG", scale_override=args.scale, device=args.device)
    print(f"graph |V|={g.num_vertices} |E|={g.num_edges}")

    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.random((g.num_vertices, D_FEAT), np.float32),
                            device=g.device)
    labels = torch.as_tensor(rng.integers(0, N_CLASSES, g.num_vertices)
                             .astype(np.int32), device=g.device)

    cfg = pna.PNAConfig(n_layers=2, d_hidden=32, node_in=D_FEAT,
                        out_dim=N_CLASSES)
    params = pna.init_params(seeded_generator(0), cfg, device=g.device)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=args.iters,
                                warmup_steps=5)
    state = (params, adamw.init_state(params))

    def loss_fn(p, batch):
        node_ids, edge_index = batch
        return pna.train_loss(p, {"node_feats": feats[node_ids],
                                  "edge_index": edge_index,
                                  "labels": labels[node_ids]}, cfg)
    step = make_grad_step(loss_fn, opt_cfg)

    losses = []
    for it in range(args.iters):
        seeds = rng.integers(0, g.num_vertices, args.batch).astype(np.int32)
        blocks, all_nodes = sample_blocks(g, seeds, FANOUTS, seed=it)
        # remap global ids -> local block ids for the union graph
        uniq = torch.unique(all_nodes)
        ei = block_union_graph(blocks)
        ei_local = torch.searchsorted(uniq, ei).to(torch.int32)
        state, aux = step(state, (uniq.long(), ei_local))
        losses.append(float(aux["loss"]))
        if it % 10 == 0:
            print(f"iter {it:3d} sampled_nodes={uniq.numel():5d} "
                  f"edges={ei.shape[1]:6d} loss={losses[-1]:.4f}")
    print("done")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in {**BAG, **SEG}.items()))
    return {"params": state[0], "losses": losses}


if __name__ == "__main__":
    main()
