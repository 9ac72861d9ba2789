"""Port serving vs the JAX package's: a checkpoint written by the JAX
package's save_checkpoint is loaded by the port's CLI path and served by
both CaptionServices at float32; the captions are identical. Plus the
threaded HTTP front end, the CaptionServer's batching contract and the
serve CLI end to end on the CPU."""

import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import serve as t_serve
from recurrent_fusion_network_torch.config import parse_opt
from recurrent_fusion_network_torch.decoding.http_serve import run_server
from recurrent_fusion_network_torch.decoding.serve import CaptionServer, pipelined_map

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny RFNet checkpoint written by the JAX package."""
    from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup
    from recurrent_fusion_network_tpu.models import setup
    from recurrent_fusion_network_tpu.training.checkpoint import save_checkpoint

    path = tmp_path_factory.mktemp("ckpt")
    opt, loader = synthetic_setup(caption_model="recurrent_fusion_model", seed=3)
    model = setup(opt)
    params = model.init_params(jax.random.PRNGKey(0))
    infos = {"opt": dict(vars(opt)), "vocab": loader.get_vocab()}
    save_checkpoint(str(path), "sv", 0, params=params, opt_state=None, infos=infos,
                    best=True)
    return str(path), model, params, loader.get_vocab()


def _requests(model, n, seed=0):
    rng = np.random.default_rng(seed)
    return [([rng.standard_normal(d).astype(np.float32) for d in model.fc_feat_sizes],
             [rng.standard_normal((a, d)).astype(np.float32)
              for a, d in zip(model.att_nums, model.att_feat_sizes)])
            for _ in range(n)]


def _port_service(path, **flags):
    argv = ["--model_path", path, "--load_model_id", "sv", "--device", "cpu",
            "--serve_dtype", "float32", "--beam_size", "3", "--serve_batch_size", "4"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return t_serve.build_service(parse_opt(argv))


def test_jax_checkpoint_serves_identical_captions(jax_checkpoint):
    from recurrent_fusion_network_tpu.decoding.http_serve import (
        CaptionService as JaxCaptionService,
    )

    path, jmodel, jparams, vocab = jax_checkpoint
    reqs = _requests(jmodel, 6)  # one full batch of 4, one partial of 2
    jsvc = JaxCaptionService(jmodel, jparams, vocab, batch_size=4, beam_size=3)
    tsvc = _port_service(path)
    try:
        assert tsvc.model.tied_att_keys == jmodel.tied_att_keys
        jfut = [jsvc.server.submit(f, a) for f, a in reqs]
        tfut = [tsvc.server.submit(f, a) for f, a in reqs]
        jout = [jsvc.postprocess_row(f.result(timeout=120)) for f in jfut]
        tout = [tsvc.postprocess_row(f.result(timeout=120)) for f in tfut]
    finally:
        jsvc.close()
        tsvc.close()
    assert [o["caption"] for o in tout] == [o["caption"] for o in jout]
    np.testing.assert_allclose([o["logprob"] for o in tout],
                               [o["logprob"] for o in jout], rtol=1e-4, atol=1e-5)
    assert tsvc.server.stats["batches"] == 2 and tsvc.server.stats["h2d_rows"] == 4 + 2


def test_threaded_http_caption_request(jax_checkpoint):
    path, jmodel, _, _ = jax_checkpoint
    svc = _port_service(path, serve_dtype="bfloat16")
    httpd = run_server(svc, "127.0.0.1", 0)
    try:
        (fcs, atts), = _requests(jmodel, 1, seed=1)
        buf = io.BytesIO()
        np.savez(buf, **{f"fc_{i}": x for i, x in enumerate(fcs)},
                 **{f"att_{i}": x for i, x in enumerate(atts)})
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/caption", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npz"})
        r = conn.getresponse()
        got = json.loads(r.read())
        assert r.status == 200 and isinstance(got["caption"], str), got
        assert np.isfinite(got["logprob"])
        conn.request("POST", "/caption", body=b'{"fc": [[1.0]], "att": [[[1.0]]]}')
        r = conn.getresponse()
        assert r.status == 400, r.read()
        r.read()
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        assert health["ok"] and health["stats"]["requests"] == 1
        conn.close()
    finally:
        httpd.shutdown()
        svc.close()
        httpd.server_close()


def _echo_server(**kw):
    """CaptionServer over a decode that returns each row's fc sum."""
    def decode(fcs, atts):
        return {"s": fcs[0].sum(dim=1), "n": torch.full((fcs[0].shape[0],),
                                                         fcs[0].shape[0])}
    return CaptionServer(decode, 8, device="cpu", **kw)


def test_caption_server_batches_pads_and_fails_requests_alone():
    srv = _echo_server(feat_dims=((3,), (2,)))
    try:
        futs = [srv.submit([np.full(3, i, np.float32)], [np.zeros((1, 2), np.float32)])
                for i in range(3)]
        for i, f in enumerate(futs):
            row = f.result(timeout=30)
            assert row["s"] == 3 * i and row["n"] == 8  # padded to batch_size
        with pytest.raises(ValueError):  # wrong trailing dim fails alone
            srv.submit([np.zeros(4, np.float32)], [np.zeros((1, 2), np.float32)])
        with pytest.raises(ValueError):  # differs from the established contract
            srv.submit([np.zeros(3, np.float32)], [np.zeros((2, 2), np.float32)])
        assert srv.stats["h2d_rows"] == 4  # 3 real rows -> pow2 bucket of 4
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit([np.zeros(3, np.float32)], [np.zeros((1, 2), np.float32)])
    assert not srv._worker.is_alive()


def test_pipelined_map_keeps_order_and_window():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 10

    out = []
    for item, res in pipelined_map(fn, range(5), depth=2):
        out.append((item, res))
        assert len(calls) - item <= 3  # at most depth results ahead
    assert out == [(i, i * 10) for i in range(5)]
    with pytest.raises(ValueError):
        list(pipelined_map(fn, [], depth=0))


def test_serve_cli_answers_and_drains_on_sigterm(jax_checkpoint):
    path, jmodel, _, _ = jax_checkpoint
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "recurrent_fusion_network_torch.serve",
         "--model_path", path, "--load_model_id", "sv", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--beam_size", "3",
         "--serve_batch_size", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    try:
        port = None
        for line in p.stdout:
            m = re.search(r"caption service on [\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server never came up"
        (fcs, atts), = _requests(jmodel, 1, seed=2)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/caption", body=json.dumps(
            {"fc": [x.tolist() for x in fcs], "att": [x.tolist() for x in atts]}))
        r = conn.getresponse()
        got = json.loads(r.read())
        assert r.status == 200 and "caption" in got, got
        conn.close()
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=60) == 0, out[-3000:]
        assert "shutdown complete" in out
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
