"""The port's asyncio front end (decoding/aio_serve.py) and the serve CLI's
front ends vs the JAX package's, on the CPU at tiny widths.

The protocol tests are JAX tests/test_serve.py's TestAsyncFrontend ones on
the port's CaptionService: keep-alive reuse, 400 / 404 / 413 / 503, npz
bodies on both front ends, the graceful drain, a client gone mid-body and a
bind error. Then a JAX checkpoint served by the JAX asyncio front end and
by the port's gives identical captions (log-probs rtol 1e-4 / atol 1e-5),
pipelined_decode gives JAX's tokens, and the serve CLI's default front end
drains on SIGTERM. Every wait has a deadline (socket timeouts, joins, the
child's stdout); servers bind port 0 and stop in ``finally``.
"""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import config as t_config
from recurrent_fusion_network_torch import serve as t_serve
from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.decoding.aio_serve import (AsyncCaptionFrontend,
                                                               run_server_async)
from recurrent_fusion_network_torch.decoding.http_serve import CaptionService, run_server
from recurrent_fusion_network_torch.models import setup as t_model

from test_torch_serve import ChildOutput, _requests

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, L, FC, ATT, A = 12, 5, 6, 5, 3
VOCAB = {str(i): f"w{i}" for i in range(1, V + 1)}


def _service(seed=0, batch_size=2, beam_size=2):
    """A CaptionService over a tiny port ShowTell from a seeded init."""
    opt = t_config.Options(caption_model="show_tell", rnn_size=8, input_encoding_size=8,
                           feat_array_info=[{"fc_feat_size": FC, "att_feat_size": ATT,
                                             "att_num": A}], device="cpu")
    opt.vocab_size, opt.seq_length = V, L
    model = t_model(opt)
    params = model.init_params(torch.Generator().manual_seed(seed), device="cpu")
    return CaptionService(model, params, VOCAB, device="cpu", batch_size=batch_size,
                          beam_size=beam_size)


def _features(seed=0):
    g = np.random.default_rng(seed)
    return ([g.standard_normal(FC).astype(np.float32)],
            [g.standard_normal((A, ATT)).astype(np.float32)])


def _json_body(fcs, atts):
    return json.dumps({"fc": [x.tolist() for x in fcs], "att": [x.tolist() for x in atts]})


def _npz_body(fcs, atts):
    buf = io.BytesIO()
    np.savez(buf, **{f"fc_{i}": x for i, x in enumerate(fcs)},
             **{f"att_{i}": x for i, x in enumerate(atts)})
    return buf.getvalue()


def _post(port, body, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/caption", body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_asyncio_server_serves_captions():
    """The captions of the in-process path, over one keep-alive connection;
    malformed JSON and wrong widths are 400 and the connection stays usable;
    an unknown path is 404."""
    svc = _service(seed=0, batch_size=4)
    fe = run_server_async(svc, "127.0.0.1", 0)
    try:
        fcs, atts = _features(1)
        want = svc.caption_features(fcs, atts)
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        assert r.status == 200 and health["frontend"] == "asyncio" and health["ok"]
        assert health["model"] == "ShowTellModel" and health["stats"]["requests"] == 1
        for _ in range(2):  # the same keep-alive connection
            conn.request("POST", "/caption", body=_json_body(fcs, atts))
            r = conn.getresponse()
            out = json.loads(r.read())
            assert r.status == 200, out
            assert out["caption"] == want["caption"]
            assert out["logprob"] == pytest.approx(want["logprob"], rel=1e-6)
        conn.request("POST", "/caption", body=b"{nope")
        r = conn.getresponse()
        assert r.status == 400 and "error" in json.loads(r.read())
        conn.request("POST", "/caption", body=json.dumps({"fc": [[0.0] * 3], "att": [[[0.0]]]}))
        r = conn.getresponse()
        assert r.status == 400, r.read()
        r.read()
        conn.request("GET", "/nothing")
        r = conn.getresponse()
        assert r.status == 404
        json.loads(r.read())
        conn.close()
    finally:
        fe.stop()
        svc.close()


def test_asyncio_malformed_content_length():
    """A non-numeric or negative Content-Length gets a 400, and an oversize
    one a 413, not a dead handler task."""
    svc = _service(seed=1)
    fe = run_server_async(svc, "127.0.0.1", 0)
    try:
        for bad, code in (("abc", 400), ("-5", 400), (str(2 ** 40), 413)):
            with socket.create_connection(("127.0.0.1", fe.port), timeout=30) as s:
                s.sendall(f"POST /caption HTTP/1.1\r\nHost: x\r\n"
                          f"Content-Length: {bad}\r\n\r\n".encode())
                resp = s.recv(4096).decode()
                assert resp.startswith(f"HTTP/1.1 {code}"), (bad, resp)
    finally:
        fe.stop()
        svc.close()


def test_binary_npz_payload_both_frontends():
    """npz bodies (by Content-Type or by the zip magic) give the JSON
    body's caption on both front ends; a corrupt zip and an npz without
    fc_i arrays are 400."""
    svc = _service(seed=3, batch_size=4)
    fcs, atts = _features(3)
    body_npz = _npz_body(fcs, atts)
    fe = run_server_async(svc, "127.0.0.1", 0)
    httpd = run_server(svc, "127.0.0.1", 0)
    try:
        for port in (fe.port, httpd.server_address[1]):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/caption", body=_json_body(fcs, atts))
            want = json.loads(conn.getresponse().read())
            for hdrs in ({"Content-Type": "application/x-npz"}, {}):
                conn.request("POST", "/caption", body=body_npz, headers=hdrs)
                r = conn.getresponse()
                got = json.loads(r.read())
                assert r.status == 200, got
                assert got["caption"] == want["caption"]
            conn.request("POST", "/caption", body=b"PK\x03\x04garbage",
                         headers={"Content-Type": "application/x-npz"})
            r = conn.getresponse()
            assert r.status == 400, r.read()
            json.loads(r.read())
            buf = io.BytesIO()
            np.savez(buf, other=fcs[0])
            conn.request("POST", "/caption", body=buf.getvalue())
            r = conn.getresponse()
            assert r.status == 400, r.read()
            r.read()
            conn.close()
    finally:
        fe.stop()
        httpd.shutdown()
        svc.close()
        httpd.server_close()


def test_npz_bad_body_is_400_not_connection_drop():
    """A bare .npy body is answered 400 on the asyncio front end."""
    svc = _service(seed=3)
    fe = run_server_async(svc, "127.0.0.1", 0)
    try:
        buf = io.BytesIO()
        np.save(buf, np.zeros(4, np.float32))
        status, body = _post(fe.port, buf.getvalue(), {"Content-Type": "application/x-npz"},
                             timeout=30)
        assert status == 400 and "error" in body, body
    finally:
        fe.stop()
        svc.close()


def test_asyncio_graceful_drain_answers_inflight_request():
    """stop(drain=True) closes the listener (a new connection is refused)
    and still answers the request being decoded."""
    svc = _service(seed=3)
    orig = svc.server.decode_fn
    svc.server.decode_fn = lambda f, a: (time.sleep(0.6), orig(f, a))[1]
    body = _json_body(*_features(4))
    fe = run_server_async(svc, "127.0.0.1", 0)
    result = {}

    def client():
        result["status"], result["body"] = _post(fe.port, body)

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.2)  # submitted; the decode sleeps
    try:
        fe.stop(drain=True, timeout=30)
        t.join(timeout=60)
        assert result.get("status") == 200, result
        assert "caption" in result["body"]
        with pytest.raises(OSError):
            s = socket.create_connection(("127.0.0.1", fe.port), timeout=2)
            # a platform may accept, then reset: force the failure
            s.sendall(b"GET /healthz HTTP/1.1\r\n\r\n")
            assert s.recv(1) == b""
            raise ConnectionRefusedError
    finally:
        t.join(timeout=60)
        svc.close()


def test_graceful_drain_not_stalled_by_idle_keepalive():
    """An idle keep-alive connection does not hold the drain: it returns
    as soon as no request is in flight."""
    svc = _service(seed=4)
    fe = run_server_async(svc, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
        conn.request("POST", "/caption", body=_json_body(*_features(5)))
        r = conn.getresponse()
        r.read()
        assert r.status == 200
        t0 = time.monotonic()  # the connection now idles in readuntil
        fe.stop(drain=True, timeout=25)
        elapsed = time.monotonic() - t0
        assert elapsed < 10, f"drain stalled {elapsed:.1f} s on an idle keep-alive connection"
        conn.close()
    finally:
        svc.close()


@pytest.mark.parametrize("frontend", ["asyncio", "threads"])
def test_closed_service_returns_503_on_both_frontends(frontend):
    """A POST once the server is closed is 503 (retryable), not 400 or 500."""
    svc = _service(seed=5)
    body = _json_body(*_features(6))
    if frontend == "asyncio":
        fe = run_server_async(svc, "127.0.0.1", 0)
        port = fe.port
    else:
        httpd = run_server(svc, "127.0.0.1", 0)
        port = httpd.server_address[1]
    try:
        svc.server.close()
        status, out = _post(port, body)
        assert status == 503, (frontend, status, out)
    finally:
        if frontend == "asyncio":
            fe.stop()
        else:
            httpd.shutdown()
            httpd.server_close()
        svc.close()


def test_failed_batch_is_500():
    svc = _service(seed=6)

    def broken(fcs, atts):
        raise RuntimeError("device lost")

    svc.server.decode_fn = broken
    fe = run_server_async(svc, "127.0.0.1", 0)
    try:
        status, out = _post(fe.port, _json_body(*_features(7)))
        assert status == 500 and "device lost" in out["error"], out
    finally:
        fe.stop()
        svc.close()


def test_asyncio_mid_body_disconnect_and_bind_error():
    """A client gone mid-body leaves the server answering; a second bind on
    the same port raises at once with the OSError."""
    svc = _service(seed=2)
    fe = run_server_async(svc, "127.0.0.1", 0)
    try:
        s = socket.create_connection(("127.0.0.1", fe.port), timeout=30)
        s.sendall(b"POST /caption HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 100000\r\n\r\npartial")
        s.close()
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        conn.close()
        fe2 = AsyncCaptionFrontend(svc)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed to start") as err:
            fe2.start("127.0.0.1", fe.port)
        assert isinstance(err.value.__cause__, OSError)
        assert time.monotonic() - t0 < 10, "the bind error took the slow path"
    finally:
        fe.stop()
        svc.close()


# ------------------------------------------------------ against the JAX package


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny RFNet checkpoint written by the JAX package."""
    from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup
    from recurrent_fusion_network_tpu.models import setup
    from recurrent_fusion_network_tpu.training.checkpoint import save_checkpoint

    path = tmp_path_factory.mktemp("ckpt")
    opt, loader = synthetic_setup(caption_model="recurrent_fusion_model", seed=5)
    model = setup(opt)
    params = model.init_params(jax.random.PRNGKey(1))
    save_checkpoint(str(path), "sv", 0, params=params, opt_state=None,
                    infos={"opt": dict(vars(opt)), "vocab": loader.get_vocab()}, best=True)
    return str(path), model, params, loader.get_vocab()


def _concurrent_captions(port, bodies):
    replies = [None] * len(bodies)

    def client(i):
        replies[i] = _post(port, bodies[i], {"Content-Type": "application/x-npz"})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None and r[0] == 200 for r in replies), replies
    return [r[1] for r in replies]


def test_jax_checkpoint_served_by_both_asyncio_frontends_gives_identical_captions(
        jax_checkpoint):
    """One JAX checkpoint, the JAX service behind the JAX asyncio front end
    and the port's serve path (f32) behind the port's: six concurrent npz
    requests get the same captions, log-probs within rtol 1e-4 / atol
    1e-5."""
    from recurrent_fusion_network_tpu.decoding.aio_serve import (
        run_server_async as j_run_server_async,
    )
    from recurrent_fusion_network_tpu.decoding.http_serve import CaptionService as JaxService

    path, jmodel, jparams, vocab = jax_checkpoint
    bodies = [_npz_body(f, a) for f, a in _requests(jmodel, 6, seed=4)]
    jsvc = JaxService(jmodel, jparams, vocab, batch_size=4, beam_size=3)
    tsvc = t_serve.build_service(t_config.parse_serve_opt([
        "--model_path", path, "--load_model_id", "sv", "--device", "cpu", "--serve_dtype",
        "float32", "--beam_size", "3", "--serve_batch_size", "4"]))
    jfe = tfe = None
    try:
        jfe = j_run_server_async(jsvc, "127.0.0.1", 0)
        tfe = run_server_async(tsvc, "127.0.0.1", 0)
        jout = _concurrent_captions(jfe.port, bodies)
        tout = _concurrent_captions(tfe.port, bodies)
    finally:
        for fe in (jfe, tfe):
            if fe is not None:
                fe.stop()
        jsvc.close()
        tsvc.close()
    assert [o["caption"] for o in tout] == [o["caption"] for o in jout]
    np.testing.assert_allclose([o["logprob"] for o in tout], [o["logprob"] for o in jout],
                               rtol=1e-4, atol=1e-5)
    assert tsvc.server.stats["requests"] == 6


def test_pipelined_decode_matches_jax():
    """pipelined_decode over four batches (depth 2) gives JAX
    pipelined_decode's tokens, which equal the sequential loop's."""
    from recurrent_fusion_network_torch.decoding.api import model_sample as t_sample
    from recurrent_fusion_network_torch.decoding.serve import pipelined_decode
    from recurrent_fusion_network_tpu.decoding.api import model_sample as j_sample
    from recurrent_fusion_network_tpu.decoding.serve import (
        pipelined_decode as j_pipelined_decode,
    )

    from test_torch_train import _batch, _models, _np_tree

    jm, tm, jp = _models("tied")
    jp = _np_tree(jp)
    # larger logits and EOS held back, so the captions are neither empty nor alike
    jp["logit"] = dict(w=jp["logit"]["w"] * 4, b=jp["logit"]["b"].copy())
    jp["logit"]["b"][0] = -3.0
    tp = params_from_jax(jp)
    batches = []
    for seed in range(4):
        fcs, atts, _, _, _ = _batch(seed=10 + seed, B=4)
        batches.append((fcs, atts))
    jdecode = jax.jit(lambda f, a: j_sample(jm, jp, f, a, beam_size=2).seq)

    def tdecode(f, a):
        with torch.inference_mode():
            return t_sample(tm, tp, f, a, beam_size=2).seq

    want = [np.asarray(s) for _, s in j_pipelined_decode(jdecode, batches, depth=2)]
    tb = [([torch.from_numpy(x) for x in f], [torch.from_numpy(x) for x in a])
          for f, a in batches]
    got = list(pipelined_decode(tdecode, iter(tb), depth=2))
    assert [b for b, _ in got] == tb  # in order, the batches themselves
    for w, (b, s) in zip(want, got):
        np.testing.assert_array_equal(s.numpy(), w)
        np.testing.assert_array_equal(tdecode(*b).numpy(), w)
    assert len({w.tobytes() for w in want}) > 1
    with pytest.raises(ValueError):
        list(pipelined_decode(tdecode, tb, depth=0))


# --------------------------------------------------------------- the serve CLI


def test_serve_cli_default_frontend_drains_on_sigterm(jax_checkpoint):
    """The serve CLI with no --serve_frontend serves from the asyncio front
    end (and takes the JAX serve flags --serve_dp_devices 1 and
    --checkpoint_backend pickle); SIGTERM drains and exits 0."""
    path, jmodel, _, _ = jax_checkpoint
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "recurrent_fusion_network_torch.serve",
         "--model_path", path, "--load_model_id", "sv", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--beam_size", "3", "--serve_batch_size", "2",
         "--serve_dp_devices", "1", "--checkpoint_backend", "pickle", "--drain_timeout", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    try:
        child = ChildOutput(p)
        m = child.wait_for(r"caption service on [\d.]+:(\d+) .*asyncio", timeout=180)
        port = int(m.group(1))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert json.loads(r.read())["frontend"] == "asyncio"
        (fcs, atts), = _requests(jmodel, 1, seed=2)
        conn.request("POST", "/caption", body=_npz_body(fcs, atts),
                     headers={"Content-Type": "application/x-npz"})
        r = conn.getresponse()
        got = json.loads(r.read())
        assert r.status == 200 and "caption" in got, got
        conn.close()
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=60)
        out = child.text()
        assert rc == 0, out[-3000:]
        assert "shutdown complete" in out
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def test_backbone_weights_switch_the_serve_cli_to_threads(monkeypatch, capsys):
    """--backbone_weights: /caption_image needs the threading front end, so
    the CLI takes it whatever --serve_frontend says, with the JAX CLI's
    message; the service's build with a backbone is
    test_torch_image_folder.py's."""
    svc = _service(seed=7)
    svc.backbone = ("params", None, 448)
    built, handlers, calls = [], {}, []
    monkeypatch.setattr(t_serve, "build_service",
                        lambda opt: built.append(opt.backbone_weights) or svc)
    monkeypatch.setattr(t_serve.signal, "signal", lambda sig, h: handlers.setdefault(sig, h))
    real_run_server = t_serve.run_server

    def run_server(*a):
        calls.append("threads")
        return real_run_server(*a)

    monkeypatch.setattr(t_serve, "run_server", run_server)
    monkeypatch.setattr(t_serve, "run_server_async", lambda *a: calls.append("asyncio"))
    cli = threading.Thread(target=t_serve.main, args=([
        "--model_path", "unused", "--load_model_id", "x", "--device", "cpu", "--host",
        "127.0.0.1", "--port", "0", "--backbone_weights", "w.pth", "--drain_timeout", "10"],))
    cli.start()
    try:
        deadline = time.monotonic() + 60
        while not calls and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        for sig in (signal.SIGTERM, signal.SIGINT):
            if sig in handlers:
                handlers[sig]()
        cli.join(timeout=60)
    assert not cli.is_alive()
    out = capsys.readouterr().out
    assert built == ["w.pth"] and calls == ["threads"], (built, calls, out)
    assert "--backbone_weights set: using the threading front end" in out
    assert "threads)" in out and "shutdown complete" in out
