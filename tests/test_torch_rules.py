"""Rules of the PyTorch port: it never imports JAX or the JAX package, and
its entry points run on CUDA unless the CPU is asked for explicitly."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import recurrent_fusion_network_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "recurrent_fusion_network_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    """In a fresh interpreter (the test process itself has JAX loaded)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 17, r.stdout


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _tiny_model():
    from recurrent_fusion_network_torch.models import RecurrentFusionModel

    return RecurrentFusionModel(vocab_size=5, seq_length=3, fc_feat_sizes=(4,),
                                att_feat_sizes=(4,), att_nums=(2,), rnn_size=4,
                                input_encoding_size=4, att_hid_size=4,
                                num_review_steps=1, num_review_steps_0=1,
                                top_words_count=3, tied_att_keys=True)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda, tmp_path):
    from recurrent_fusion_network_torch.config import Options
    from recurrent_fusion_network_torch import eval as eval_cli
    from recurrent_fusion_network_torch import eval_ensemble, main, main_rl, serve
    from recurrent_fusion_network_torch.decoding.http_serve import CaptionService
    from recurrent_fusion_network_torch.decoding.serve import CaptionServer
    from recurrent_fusion_network_torch.device import resolve_device
    from recurrent_fusion_network_torch.training.multi_seed import (train_multi_seed,
                                                                    train_multi_seed_rl)

    model = _tiny_model()
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    for make in (
        lambda: resolve_device(None),
        lambda: model.init_params(torch.Generator().manual_seed(0)),
        lambda: CaptionService(model, params, {"1": "a"}),
        lambda: CaptionServer(lambda f, a: None, 2),
        # before the (missing) checkpoint or data is read
        lambda: serve.main(["--model_path", str(tmp_path), "--load_model_id", "x"]),
        lambda: eval_cli.main(["--model_path", str(tmp_path), "--load_model_id", "x"]),
        lambda: main.main(["--feature_type", "synthetic", "--input_json", str(tmp_path)]),
        lambda: main_rl.main(["--feature_type", "synthetic", "--start_from", str(tmp_path)]),
        lambda: eval_ensemble.main(["--model_path", str(tmp_path), "--model_ids", "x",
                                    "--n_ranks", "2"]),
        lambda: main.main(["--feature_type", "synthetic", "--n_seeds", "2"]),
        lambda: main_rl.main(["--feature_type", "synthetic", "--n_seeds", "2",
                              "--start_from", str(tmp_path)]),
        # the fleets themselves, before the (unread) loader is touched
        lambda: train_multi_seed(Options(), None, 2),
        lambda: train_multi_seed_rl(Options(), None, None, 2),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    svc = CaptionService(model, params, {str(i): f"w{i}" for i in range(1, 6)},
                         device="cpu", batch_size=2, beam_size=2)
    try:
        out = svc.caption_features([np.ones(4, np.float32)], [np.ones((2, 4), np.float32)])
    finally:
        svc.close()
    assert isinstance(out["caption"], str) and np.isfinite(out["logprob"])


def test_checkpoint_loader_refuses_foreign_classes(tmp_path):
    """The loader rebuilds the JAX package's EncoderInfo as the port's own
    class and refuses any other class outside numpy / builtins."""
    import pickle

    from recurrent_fusion_network_torch.feat_registry import EncoderInfo
    from recurrent_fusion_network_torch.training.checkpoint import load_checkpoint
    from recurrent_fusion_network_tpu import feat_registry as jax_registry

    infos = {"opt": {"feat_array_info": jax_registry.feat_array_info()}, "vocab": {"1": "a"}}
    with open(tmp_path / "model_r_0-best.pkl", "wb") as f:
        pickle.dump({"w": np.ones((2, 2), np.float32)}, f)
    with open(tmp_path / "infos_r_0-best.pkl", "wb") as f:
        pickle.dump(infos, f)
    params, got = load_checkpoint(str(tmp_path), "r", 0)
    assert params["w"].shape == (2, 2)
    fai = got["opt"]["feat_array_info"]
    assert all(type(e) is EncoderInfo for e in fai)
    assert [e["att_num"] for e in fai] == [196, 64, 64, 49, 64]
    with open(tmp_path / "infos_r_0-best.pkl", "wb") as f:
        pickle.dump({"bad": subprocess.Popen}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(str(tmp_path), "r", 0)
