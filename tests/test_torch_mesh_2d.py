"""The port's dp x mp mesh (``--num_mp_devices``, ``parallel/mesh.py``) on
a 1 x 2 and a 2 x 2 gloo cluster on the CPU (``tests/_torch_mesh_worker.py``,
each rank a subprocess with a deadline), against the port's single-process
runs and the JAX package, at the synthetic fixture's widths (V + 1 = 36,
width 16, 4 images x 2 captions a global batch):

  * the layout: rank r is dp index r // mp and mp index r % mp, its dp
    group the ranks of its mp index, its mp group a run of consecutive
    ranks, its loader shard (dp index, dp);
  * the shards: logit w / b by columns and embed by rows, their Adam
    moments alike, the rest shared; gathered back bit for bit; at V + 1 =
    9488 for mp 2 and 4 the shapes of JAX's ``addressable_shards``;
    ``ValueError`` for an uneven vocabulary and for a world that is not
    dp x mp;
  * the first XE step (dropout 0) of RFNet, ReviewNet with MoS, ShowTell
    and RFNet under ``--use_remat 1 --remat_policy full``: the loss and the
    gathered gradients leaf by leaf against the port's solo step and the
    JAX solo step (rtol 1e-4 / atol 1e-6; the score biases, whose true
    gradient is 0, at atol 1e-6), and bit for bit on every rank;
  * ``train`` for 3 steps from a JAX triple, a boundary at step 2: the loss
    history against the port's solo run (rtol 1e-4) and JAX ``train`` on
    ``make_mesh_2d(dp, mp)`` (rtol 2e-3, the JAX package's own 2-D
    tolerance); the final params bit for bit on every rank (the replicated
    leaves need no mp collective); the boundary's triple the full tree, bit
    for bit, in the JAX package's layout;
  * ``train`` resumed from that triple to step 8 with dropout 0.3 and
    scheduled sampling from epoch 1: the port's solo resume's losses and
    params (rtol 1e-4 / atol 1e-6), bit for bit on every rank;
  * the CLIs: ``main --num_mp_devices 2 --device cpu`` trains on 2 gloo
    ranks and writes the full triple; ``--n_seeds 2`` with mp 2 and
    ``main_rl --num_mp_devices 2`` fail as in JAX, before any loader.
"""

import os
import pickle
import signal
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import main as t_main
from recurrent_fusion_network_torch import main_rl as t_main_rl
from recurrent_fusion_network_torch.convert import params_from_jax, params_to_jax
from recurrent_fusion_network_torch.data.synthetic import synthetic_setup as t_setup
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.parallel import distributed
from recurrent_fusion_network_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                                          shard_opt_state_2d, shard_params_2d)
from recurrent_fusion_network_torch.parallel.distributed import free_port
from recurrent_fusion_network_torch.training import checkpoint as t_ckpt
from recurrent_fusion_network_torch.training.criterion import make_criterion as t_crit
from recurrent_fusion_network_torch.training.optim import AdamState, make_optimizer
from recurrent_fusion_network_torch.training.train_loop import make_train_step
from recurrent_fusion_network_torch.training.train_loop import train as t_train
from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup as j_setup
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
from recurrent_fusion_network_tpu.training.criterion import make_criterion as j_crit
from recurrent_fusion_network_tpu.training.eval_split import batch_feats

import _torch_mesh_worker as worker
from test_torch_drivers import TINY_FLAGS
from test_torch_serve import ChildOutput
from test_torch_train import _is_score_bias, _pairs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
CLUSTER_TIMEOUT_S = 180
GRIDS = ((1, 2), (2, 2))
RTOL, ATOL = 1e-4, 1e-6
JAX_2D_RTOL = 2e-3
CASES = {"rfnet": {},
         "review_net_mos": dict(caption_model="review_net", use_mos=1, num_expert=3),
         "show_tell": dict(caption_model="show_tell"),
         "rfnet_remat_full": dict(use_remat=1, remat_policy="full")}


def quiet(*_args, **_kwargs):
    pass


def _jax_case(over):
    """(the worker's case: options, JAX params, the first global batch;
    a thunk of JAX's solo loss and gradients)."""
    jopt, jl = j_setup(batch_size=4, seq_per_img=2, **over)
    jopt.vocab_size, jopt.seq_length = jl.vocab_size, jl.seq_length
    model, crit = j_model(jopt), j_crit(jopt)
    params = jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(3)))
    data = jl.get_batch("train")
    fc, att = batch_feats(data, as_numpy=True)  # bare arrays for a single encoder
    single = jopt.caption_model != "recurrent_fusion_model"
    fc, att = ([fc], [att]) if single else (fc, att)
    case = {"opt": over, "params": params, "fc": [np.asarray(x) for x in fc],
            "att": [np.asarray(x) for x in att],
            **{k: np.asarray(data[k]) for k in ("labels", "masks", "top_words")}}

    def loss_fn(p, fc, att, labels, masks, top_words):
        lps, reason = model.forward(p, fc[0] if single else fc, att[0] if single else att,
                                    labels)
        return crit(lps, labels, masks, reason, top_words)

    def step():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            params, case["fc"], case["att"], case["labels"], case["masks"], case["top_words"])
        return float(loss), jax.tree_util.tree_map(np.asarray, grads)

    return case, step


def _solo_step(case):
    """The port's single-process first step on the whole batch: (loss,
    the gradients the optimizer receives)."""
    opt, _ = t_setup(batch_size=4, seq_per_img=2, device="cpu", **case["opt"])
    spy = worker.GradCopy(make_optimizer(opt))
    params = params_from_jax(case["params"])
    batch = ([torch.from_numpy(x) for x in case["fc"]], [torch.from_numpy(x) for x in case["att"]],
             *(torch.from_numpy(case[k]) for k in ("labels", "masks", "top_words")))
    step = make_train_step(t_model(opt), t_crit(opt), spy)
    _, _, loss = step(params, spy.init(params), *batch, opt.optim_lr, 0.0,
                      torch.Generator().manual_seed(0))
    return float(loss), params_to_jax(spy.grads)


def _start(out, dp, mp):
    port = str(free_port())
    procs = []
    for r in range(dp * mp):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE=str(dp * mp), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(dp * mp), PYTHONUNBUFFERED="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(out), str(dp), str(mp)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, [ChildOutput(p) for p in procs]


def _finish(out, procs, outputs):
    try:
        for p in procs:
            p.wait(timeout=CLUSTER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{outputs[r].text()[-4000:]}"
    results = []
    for r in range(len(procs)):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _jax_train(out, grid, tmp):
    """JAX ``train`` from the zero triple for A_STEPS steps on
    ``make_mesh_2d(*grid)``, without boundaries."""
    from recurrent_fusion_network_tpu.parallel.mesh import make_mesh_2d as j_mesh_2d
    from recurrent_fusion_network_tpu.training.train_loop import train as j_train

    jopt, jl = j_setup(batch_size=4, seq_per_img=2, losses_log_every=1,
                       start_from=str(out / "zero"), load_model_id="zero",
                       save_checkpoint_every=10**9)
    jopt.checkpoint_path = str(tmp)
    return j_train(jopt, jl, max_iterations=worker.A_STEPS, mesh=j_mesh_2d(*grid),
                   log_fn=quiet)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Both clusters run at once, on the same cases and the same JAX
    triple at step 0, while this process runs the JAX side: {(dp, mp):
    (out dir, each rank's results, JAX train on that mesh)}, the cases and
    JAX's solo steps of them."""
    cases, thunks = {}, {}
    for name, over in CASES.items():
        cases[name], thunks[name] = _jax_case(over)
    jopt, _ = j_setup(batch_size=4, seq_per_img=2)
    jopt.vocab_size, jopt.seq_length = cases["rfnet"]["params"]["logit"]["b"].shape[0] - 1, 8
    started = {}
    for dp, mp in GRIDS:
        out = tmp_path_factory.mktemp(f"grid{dp}x{mp}")
        with open(out / "given.pkl", "wb") as f:
            pickle.dump({"params": cases["rfnet"]["params"], "cases": cases}, f)
        j_ckpt.save_checkpoint(str(out / "zero"), "zero", 0, params=cases["rfnet"]["params"],
                               infos={"iter": 0, "epoch": 0, "opt": dict(vars(jopt))})
        started[dp, mp] = (out, *_start(out, dp, mp))
    jax_steps = {name: step() for name, step in thunks.items()}
    jax_runs = {grid: _jax_train(out, grid, tmp_path_factory.mktemp("jax"))
                for grid, (out, _, _) in started.items()}
    runs = {grid: (out, _finish(out, procs, outputs), jax_runs[grid])
            for grid, (out, procs, outputs) in started.items()}
    return runs, cases, jax_steps


def _bits(tree):
    return [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(tree)]


def _close_trees(got, want, rtol=RTOL, atol=ATOL):
    n = 0
    for path, w, g in _pairs(want, got):
        n += 1
        if _is_score_bias(path):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=path)
    assert n > 5


@pytest.mark.parametrize("grid", GRIDS)
def test_the_ranks_lay_out_as_dp_by_mp(grids, grid):
    runs, _, _ = grids
    dp, mp = grid
    for r, res in enumerate(runs[grid][1]):
        lay = res["layout"]
        assert (lay["rank"], lay["dp_index"], lay["mp_index"]) == (r, r // mp, r % mp)
        assert lay["mp_ranks"] == list(range(r // mp * mp, r // mp * mp + mp))
        assert lay["dp_ranks"] == [d * mp + r % mp for d in range(dp)]
        assert lay["host_shard"] == (r // mp, dp)


@pytest.mark.parametrize("grid", GRIDS)
def test_shards_gather_back_bit_for_bit(grids, grid):
    """The logit by columns and the embedding by rows, 36 / mp each, their
    moments alike, the count and the replicated leaves untouched; the
    gather returns the full params and moments bit for bit."""
    runs, cases, _ = grids
    params = cases["rfnet"]["params"]
    mp = grid[1]
    for res in runs[grid][1]:
        trip = res["trip"]
        assert trip["shapes"] == {"w": (16, 36 // mp), "b": (36 // mp,), "embed": (36 // mp, 16),
                                  "mu_w": (16, 36 // mp), "nu_embed": (36 // mp, 16),
                                  "count": 3, "replicated_shared": True}
        assert _bits(trip["params"]) == _bits(params)
        assert _bits(trip["mu"]) == _bits(jax.tree_util.tree_map(lambda x: 2 * x, params))
        assert _bits(trip["nu"]) == _bits(jax.tree_util.tree_map(lambda x: x * x, params))
        assert trip["count"] == 3


@pytest.mark.parametrize("mp", [2, 4])
def test_flagship_vocab_shards_have_jax_shapes(mp):
    """At V + 1 = 9488 the port's shards of logit w / b, the embedding and
    their Adam moments have the shapes of the JAX 2-D mesh's addressable
    shards (tests/test_distributed.py:399-401)."""
    from recurrent_fusion_network_tpu.parallel.mesh import make_mesh_2d as j_mesh_2d
    from recurrent_fusion_network_tpu.parallel.mesh import shard_params_2d as j_shard

    jopt, _ = j_setup(batch_size=4, seq_per_img=2, num_review_steps=1, num_review_steps_0=1)
    jopt.vocab_size, jopt.seq_length = 9487, 8
    jparams = j_model(jopt).init_params(jax.random.PRNGKey(0))
    jsharded = j_shard(j_mesh_2d(8 // mp, mp), jparams)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for index in range(mp):
        mesh = types.SimpleNamespace(mp=mp, mp_index=index)
        sp = shard_params_2d(mesh, params)
        state = shard_opt_state_2d(mesh, make_optimizer(jopt).init(params), params, sp)
        for got, j in ((sp["logit"]["w"], jsharded["logit"]["w"]),
                       (sp["logit"]["b"], jsharded["logit"]["b"]),
                       (sp["embed"], jsharded["embed"]),
                       (state.mu["logit"]["w"], jsharded["logit"]["w"]),
                       (state.nu["embed"], jsharded["embed"])):
            assert tuple(got.shape) == j.addressable_shards[0].data.shape
        n = 9488 // mp
        assert torch.equal(sp["logit"]["w"], params["logit"]["w"][:, index * n:(index + 1) * n])
        assert torch.equal(sp["embed"], params["embed"][index * n:(index + 1) * n])


def test_an_uneven_vocab_and_a_world_not_dp_by_mp_raise(monkeypatch):
    params = {"logit": {"w": torch.zeros(4, 35), "b": torch.zeros(35)},
              "embed": torch.zeros(35, 4), "core": torch.zeros(3)}
    with pytest.raises(ValueError, match=r"vocabulary axis \(35 = V \+ 1\) does not divide"):
        shard_params_2d(types.SimpleNamespace(mp=2, mp_index=0), params)
    state = AdamState(count=0, mu=params, nu=params)
    with pytest.raises(ValueError, match="does not divide by the 2 mp ranks"):
        shard_opt_state_2d(types.SimpleNamespace(mp=2, mp_index=1), state, params)
    monkeypatch.setattr(distributed, "_cluster", distributed.Cluster(
        0, 4, torch.device("cpu"), "gloo", None))
    with pytest.raises(ValueError, match=r"a 3 x 2 \(dp x mp\) mesh needs 6 rank\(s\); the "
                                         r"process group has 4"):
        make_mesh_2d(3, 2)
    # the layout is the group's, fixed when it was joined: a mesh checks it
    with pytest.raises(ValueError, match="laid out with mp 1: pass mp=2"):
        make_mesh_2d(2, 2)
    monkeypatch.setattr(distributed, "_cluster", distributed.Cluster(
        0, 4, torch.device("cpu"), "gloo", None, mp=2))
    with pytest.raises(ValueError, match="laid out dp x mp with mp 2"):
        make_mesh(4)
    assert make_mesh_2d(2, 2).mp == 2 and distributed.host_shard() == (0, 2)
    monkeypatch.setattr(distributed, "_cluster", None)
    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "4",
                 "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="do not make a dp x mp grid with mp 3"):
        distributed.initialize(device="cpu", mp=3)  # raised before joining
    assert distributed.cluster() is None


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_first_step_equals_the_solo_and_the_jax_steps(grids, grid, case):
    runs, cases, jax_steps = grids
    solo_loss, solo_grads = _solo_step(cases[case])
    jloss, jgrads = jax_steps[case]
    results = runs[grid][1]
    for res in results:
        got = res["steps"][case]
        np.testing.assert_allclose(got["loss"], solo_loss, rtol=RTOL)
        np.testing.assert_allclose(got["loss"], jloss, rtol=RTOL)
        _close_trees(got["grads"], solo_grads)
        _close_trees(got["grads"], jgrads)
        assert _bits(got["grads"]) == _bits(results[0]["steps"][case]["grads"])


def _solo_run(tmp, name, start_from, load_id, steps, **over):
    opt, loader = t_setup(batch_size=4, seq_per_img=2, losses_log_every=1, device="cpu",
                          eval_results_dir=str(tmp / "er"), start_from=start_from,
                          load_model_id=load_id, **over)
    opt.checkpoint_path, opt.id = str(tmp / name), name
    return t_train(opt, loader, max_iterations=steps, log_fn=quiet)


@pytest.mark.parametrize("grid", GRIDS)
def test_train_and_resume_on_the_mesh_follow_the_solo_and_jax_runs(grids, grid, tmp_path):
    runs, cases, _ = grids
    out, results, ja = runs[grid]
    a = _solo_run(tmp_path, "a", str(out / "zero"), "zero", worker.A_STEPS,
                  save_checkpoint_every=2, val_images_use=4, language_eval=0)
    steps = list(range(worker.A_STEPS))
    for res in results:
        got = [res["a"]["loss_history"][k] for k in steps]
        np.testing.assert_allclose(got, [a["loss_history"][k] for k in steps], rtol=RTOL)
        np.testing.assert_allclose(got, [ja["loss_history"][k] for k in steps],
                                   rtol=JAX_2D_RTOL)
        _close_trees(res["a"]["params"], params_to_jax(a["final_params"]))
        assert _bits(res["a"]["params"]) == _bits(results[0]["a"]["params"])

    # the boundary at step 2 wrote the params after it: the full tree, in
    # the JAX package's layout, once (rank 0)
    triple, _, infos = j_ckpt.load_checkpoint(str(out / "a"), "mp", 0, best=False)
    assert infos["iter"] == worker.A_STEPS
    assert (jax.tree_util.tree_structure(triple)
            == jax.tree_util.tree_structure(cases["rfnet"]["params"]))
    assert _bits(triple) == _bits(results[0]["a"]["params"])
    assert sorted(os.listdir(out / "a")) == sorted(
        f"{k}_mp_0{s}.pkl" for k in ("model", "optimizer", "infos") for s in ("", "-best"))

    b = _solo_run(tmp_path, "b", str(out / "a"), "mp", worker.B_STEPS,
                  save_checkpoint_every=100, **worker.RESUMED)
    assert max(b["ss_prob_history"].values()) > 0  # scheduled sampling ran
    resumed = list(range(worker.A_STEPS, worker.B_STEPS))  # the triple's history before
    assert sorted(b["loss_history"]) == list(range(worker.B_STEPS))
    for res in results:
        assert sorted(res["b"]["loss_history"]) == list(range(worker.B_STEPS))
        np.testing.assert_allclose([res["b"]["loss_history"][k] for k in resumed],
                                   [b["loss_history"][k] for k in resumed], rtol=RTOL)
        _close_trees(res["b"]["params"], params_to_jax(b["final_params"]))
        assert _bits(res["b"]["params"]) == _bits(results[0]["b"]["params"])


def test_main_trains_on_a_one_by_two_mesh(tmp_path):
    """main --num_mp_devices 2 --device cpu starts 2 gloo ranks of its own;
    rank 0 alone prints and writes the boundary's triples, which hold the
    full tree and record the mp count. A session of its own, killed whole
    past a deadline."""
    ck = tmp_path / "ck"
    argv = TINY_FLAGS + ["--num_mp_devices", "2", "--checkpoint_path", str(ck), "--id", "mp",
                         "--max_iterations", "3", "--save_checkpoint_every", "2",
                         "--val_images_use", "4", "--language_eval", "0",
                         "--eval_results_dir", str(tmp_path / "er")]
    proc = subprocess.Popen([sys.executable, "-m", "recurrent_fusion_network_torch.main",
                             *argv], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        printed, _ = proc.communicate(timeout=CLUSTER_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, printed[-4000:]
    assert printed.count("iter 2,") == 1
    assert sorted(os.listdir(ck)) == sorted(f"{k}_mp_0{s}.pkl"
                                            for k in ("model", "optimizer", "infos")
                                            for s in ("", "-best"))
    params, infos = t_ckpt.load_checkpoint(str(ck), "mp", 0, best=False)
    assert infos["iter"] == 3 and infos["opt"]["num_mp_devices"] == 2
    assert params["logit"]["w"].shape == (16, 36) and params["embed"].shape == (36, 16)


def test_fleets_and_scst_refuse_the_mp_axis_before_any_loader(monkeypatch):
    """As the JAX CLIs: --n_seeds 2 with --num_mp_devices 2 fails, and
    main_rl fails for --num_mp_devices 2 before it builds its loader or
    its CIDEr-D table."""
    def no_loader(*_a, **_k):
        raise AssertionError("the loader was built")

    monkeypatch.setattr(t_main, "build_loader", no_loader)
    monkeypatch.setattr(t_main_rl, "build_loader", no_loader)
    with pytest.raises(ValueError, match=r"fleets \(--n_seeds\) shard the seed axis over dp"):
        t_main.main(TINY_FLAGS + ["--num_mp_devices", "2", "--n_seeds", "2"])
    with pytest.raises(ValueError, match="not supported by the RL loop"):
        t_main_rl.main(TINY_FLAGS + ["--num_mp_devices", "2"])
