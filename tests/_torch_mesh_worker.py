"""Worker of tests/test_torch_mesh_2d.py: one rank of a dp x mp gloo
cluster on the CPU.

    python tests/_torch_mesh_worker.py OUT_DIR DP MP

with torchrun's environment set by the test. It joins the group laid out
as dp x mp (``parallel.distributed.initialize(mp=...)``,
``parallel.mesh.make_mesh_2d``) and pickles to OUT_DIR/rank{RANK}.pkl:

  layout  its dp / mp indices, the ranks of its dp and mp groups and its
          loader shard;
  trip    the params and Adam moments of OUT_DIR/given.pkl sharded and
          gathered back, and the shards' shapes;
  steps   per case of given.pkl (options, JAX params, one global batch at
          dropout 0): the first XE step's loss and the gradients the
          optimizer receives, gathered to full trees;
  a       ``train`` from the JAX triple OUT_DIR/zero for 3 steps with a
          boundary at step 2 (the triple under OUT_DIR/a): the loss history
          and the final params;
  b       ``train`` resumed from that triple to step 8 with dropout 0.3 and
          scheduled sampling from epoch 1: the loss history and the final
          params.

It imports no JAX.
"""

import dataclasses
import os
import pickle
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

import _torch_dist_worker as base  # noqa: E402

from recurrent_fusion_network_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from recurrent_fusion_network_torch.models import setup as make_model  # noqa: E402
from recurrent_fusion_network_torch.ops.initializers import tree_map  # noqa: E402
from recurrent_fusion_network_torch.parallel import distributed  # noqa: E402
from recurrent_fusion_network_torch.parallel.mesh import (  # noqa: E402
    gather_opt_state_2d, gather_params_2d, make_mesh_2d, shard_opt_state_2d, shard_params_2d)
from recurrent_fusion_network_torch.training.criterion import make_criterion  # noqa: E402
from recurrent_fusion_network_torch.training.optim import AdamState, make_optimizer  # noqa: E402
from recurrent_fusion_network_torch.training.train_loop import (make_train_step,  # noqa: E402
                                                                train)

A_STEPS, B_STEPS = 3, 8
RESUMED = dict(drop_prob_lm=0.3, drop_prob_reason=0.3, drop_prob_fusion=0.3,
               scheduled_sampling_start=0, scheduled_sampling_increase_every=1,
               scheduled_sampling_increase_prob=0.25)


class GradCopy:
    """The optimizer with a copy of the gradients it is handed (before its
    clamp acts on them in place)."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads = tree_map(torch.clone, grads)
        return self.tx.update(grads, state, params)


def layout(c):
    def ranks(group):
        return list(range(c.world)) if group is None else dist.get_process_group_ranks(group)

    return {"rank": c.rank, "dp_index": c.dp_index, "mp_index": c.mp_index,
            "dp_ranks": ranks(c.dp_group), "mp_ranks": ranks(c.mp_group),
            "host_shard": distributed.host_shard()}


def round_trip(mesh, given):
    params = params_from_jax(given["params"])
    state = AdamState(count=3, mu=tree_map(lambda x: 2 * x, params),
                      nu=tree_map(lambda x: x * x, params))
    sp = shard_params_2d(mesh, params)
    ss = shard_opt_state_2d(mesh, state, params, sp)
    shapes = {"w": tuple(sp["logit"]["w"].shape), "b": tuple(sp["logit"]["b"].shape),
              "embed": tuple(sp["embed"].shape), "mu_w": tuple(ss.mu["logit"]["w"].shape),
              "nu_embed": tuple(ss.nu["embed"].shape), "count": ss.count,
              "replicated_shared": sp["decoder"] is params["decoder"]}
    gs = gather_opt_state_2d(mesh, ss, sp)
    return {"shapes": shapes, "params": params_to_jax(gather_params_2d(mesh, sp)),
            "mu": params_to_jax(gs.mu), "nu": params_to_jax(gs.nu), "count": gs.count}


def first_steps(out, mesh, given):
    res = {}
    for name, case in given["cases"].items():
        opt, _ = base.setup(out, "step", (0, 1), **case["opt"])
        model = dataclasses.replace(make_model(opt), vocab_parallel=mesh.vocab)
        spy = GradCopy(make_optimizer(opt))
        params = shard_params_2d(mesh, params_from_jax(case["params"]))
        n = case["labels"].shape[0] // mesh.dp
        rows = slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)
        batch = ([torch.from_numpy(x[rows]) for x in case["fc"]],
                 [torch.from_numpy(x[rows]) for x in case["att"]],
                 *(torch.from_numpy(case[k][rows]) for k in ("labels", "masks", "top_words")))
        step = make_train_step(model, make_criterion(opt), spy, None, mesh)
        _, _, loss = step(params, spy.init(params), *batch, opt.optim_lr, 0.0,
                          mesh.draws(torch.Generator().manual_seed(0)))
        res[name] = {"loss": float(loss),
                     "grads": params_to_jax(gather_params_2d(mesh, spy.grads))}
    return res


def loops(out, mesh, shard):
    opt, loader = base.setup(out, "a", shard, start_from=os.path.join(out, "zero"),
                             load_model_id="zero", save_checkpoint_every=2, val_images_use=4,
                             language_eval=0)
    opt.id = "mp"
    a = train(opt, loader, max_iterations=A_STEPS, log_fn=base.quiet, mesh=mesh)
    opt, loader = base.setup(out, "b", shard, start_from=os.path.join(out, "a"),
                             load_model_id="mp", save_checkpoint_every=100, **RESUMED)
    b = train(opt, loader, max_iterations=B_STEPS, log_fn=base.quiet, mesh=mesh)
    return {name: {"loss_history": r["loss_history"],
                   "params": base.numpy_tree(r["final_params"])}
            for name, r in (("a", a), ("b", b))}


def main():
    out, dp, mp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    c = distributed.initialize(device="cpu", mp=mp)
    try:
        mesh = make_mesh_2d(dp, mp)
        with open(os.path.join(out, "given.pkl"), "rb") as f:
            given = pickle.load(f)
        res = {"layout": layout(distributed.cluster()), "trip": round_trip(mesh, given),
               "steps": first_steps(out, mesh, given)}
        res.update(loops(out, mesh, distributed.host_shard()))
        with open(os.path.join(out, f"rank{c.rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
