"""The single-process device mesh of the port (``parallel/mesh.py::
DeviceMesh``) against no mesh and against the JAX package on a 2-device
mesh (the conftest's virtual CPU devices), on a mesh of the CPU twice:

  * ``with_dp_sharding`` / ``replicate`` / ``join_blocks``: contiguous
    blocks, one a device, joined back in order; a batch that does not
    divide is refused; ``make_device_mesh`` refuses more devices than given;
  * ``CaptionServer`` / ``CaptionService`` (``--serve_dp_devices 2`` through
    ``serve.build_service``'s device list): the no-mesh service's tokens and
    log-probs, and the JAX service's on ``make_mesh(2)``; the stats JAX
    keeps; the divisibility ``ValueError`` in JAX's words; the CLI's refusal
    of more devices than visible;
  * ``eval_ensemble(mesh=...)``: plain, flip and diff-feat predictions equal
    to no mesh and to JAX's ``eval_ensemble(mesh=make_mesh(2))``;
  * ``eval_split(mesh=...)``: the no-mesh predictions, the loss within
    rounding.
"""

import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import serve as t_serve
from recurrent_fusion_network_torch.config import parse_serve_opt
from recurrent_fusion_network_torch.decoding.serve import CaptionServer
from recurrent_fusion_network_torch.parallel.mesh import (DeviceMesh, join_blocks,
                                                          make_device_mesh, replicate,
                                                          with_dp_sharding)
from recurrent_fusion_network_tpu.parallel.mesh import make_mesh

from test_torch_ensemble import _fixture_members, _loaders, _review_members
from test_torch_serve import _requests, jax_checkpoint  # noqa: F401 (a fixture)

torch.set_num_threads(1)
CPU2 = ["cpu", "cpu"]


def test_blocks_are_contiguous_one_a_device_and_join_back_in_order():
    mesh = make_device_mesh(2, CPU2)
    tree = ([torch.arange(12.0).reshape(6, 2)], {"x": torch.arange(6)})
    blocks = with_dp_sharding(mesh, tree)
    assert len(blocks) == 2
    np.testing.assert_array_equal(blocks[1][0][0].numpy(), [[6, 7], [8, 9], [10, 11]])
    assert blocks[0][1]["x"].tolist() == [0, 1, 2]
    joined = join_blocks([(b[0], b[1], None) for b in blocks])
    assert torch.equal(joined[0][0], tree[0][0]) and torch.equal(joined[1]["x"], tree[1]["x"])
    assert joined[2] is None
    assert all(r["w"] is w for r, w in zip(replicate(mesh, {"w": tree[1]["x"]}),
                                            [tree[1]["x"]] * 2))
    with pytest.raises(ValueError, match="does not divide by the mesh's 4 devices"):
        with_dp_sharding(DeviceMesh(["cpu"] * 4), tree)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        make_device_mesh(3, CPU2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            make_device_mesh(2)


def _service(path, devices=None, **flags):
    argv = ["--model_path", path, "--load_model_id", "sv", "--device", "cpu",
            "--serve_dtype", "float32", "--beam_size", "3", "--serve_batch_size", "4"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return t_serve.build_service(parse_serve_opt(argv), devices=devices)


def _serve(svc, reqs):
    futs = [svc.server.submit(f, a) for f, a in reqs]
    return [svc.postprocess_row(f.result(timeout=120)) for f in futs]


def test_the_service_on_a_mesh_gives_the_no_mesh_and_the_jax_mesh_captions(jax_checkpoint):
    """--serve_dp_devices 2 over [cpu, cpu]: one full batch of 4 and one
    partial of 2 (padded on the host to 4, as under the JAX mesh), warmed
    up on both devices; captions equal the no-mesh service's and the JAX
    service's on a 2-device mesh, log-probs to rounding."""
    from recurrent_fusion_network_tpu.decoding.http_serve import (
        CaptionService as JaxCaptionService,
    )

    path, jmodel, jparams, vocab = jax_checkpoint
    reqs = _requests(jmodel, 6)
    plain, meshed = _service(path), _service(path, CPU2, serve_dp_devices=2)
    jsvc = JaxCaptionService(jmodel, jparams, vocab, batch_size=4, beam_size=3,
                             mesh=make_mesh(2))
    try:
        assert meshed.mesh.dp == 2 and not meshed.server.device_pad
        meshed.warmup()
        got, want, jgot = _serve(meshed, reqs), _serve(plain, reqs), _serve(jsvc, reqs)
    finally:
        for s in (plain, meshed, jsvc):
            s.close()
    assert [o["caption"] for o in got] == [o["caption"] for o in want] == [
        o["caption"] for o in jgot]
    np.testing.assert_allclose([o["logprob"] for o in got], [o["logprob"] for o in want],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose([o["logprob"] for o in got], [o["logprob"] for o in jgot],
                               rtol=1e-4, atol=1e-5)
    assert meshed.server.stats == jsvc.server.stats == {
        "requests": 6, "batches": 2, "padded_rows": 2, "h2d_rows": 8}


def test_the_mesh_refuses_a_batch_that_does_not_divide_and_more_devices_than_visible(
        jax_checkpoint):
    """JAX's ValueError text for a batch size the dp extent does not
    divide; the CLI asks for the first N visible devices and raises where
    there are fewer (one CPU under --device cpu)."""
    from recurrent_fusion_network_tpu.decoding.serve import CaptionServer as JaxServer

    with pytest.raises(ValueError) as jerr:
        JaxServer(lambda f, a: f, 6, mesh=make_mesh(4))
    with pytest.raises(ValueError) as terr:
        CaptionServer(lambda f, a: f, 6, mesh=DeviceMesh(["cpu"] * 4))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        _service(jax_checkpoint[0], serve_dp_devices=2)


def test_a_mesh_server_takes_one_decoder_a_device():
    """On a mesh decode_fn is a list of callables, one a device: a single
    callable or a list of another length is refused."""
    mesh = DeviceMesh(["cpu"] * 2)
    for fns in (lambda f, a: f, [lambda f, a: f] * 3):
        with pytest.raises(ValueError, match="decode_fn is a list of 2 callables"):
            CaptionServer(fns, 4, mesh=mesh)
    server = CaptionServer([lambda f, a: f] * 2, 4, mesh=mesh)
    server.close()


@pytest.mark.parametrize("mode", ["plain", "flip", "diff_feat"])
def test_eval_ensemble_on_a_mesh_equals_no_mesh_and_the_jax_mesh(tmp_path, mode):
    """The fixture's val split, 8 images in batches of 4 over [cpu, cpu]:
    plain (two RFNets, beam 3), flip (beam 2) and diff-feat (two ReviewNets,
    greedy) predictions equal the no-mesh ones and JAX's on make_mesh(2)."""
    from recurrent_fusion_network_tpu.training.eval_ensemble import eval_ensemble as j_eval
    from recurrent_fusion_network_torch.training.eval_ensemble import eval_ensemble as t_eval

    jopt, topt, jl, tl = _loaders(tmp_path)
    members = (_review_members(jopt, topt, 2) if mode == "diff_feat"
               else _fixture_members(jopt, topt))
    kw = dict(split="val", val_images_use=8, beam_size={"plain": 3, "flip": 2}.get(mode, 1),
              diff_feat=mode == "diff_feat", flip_ensemble=mode == "flip",
              language_eval_flag=False)
    tm = [(m[2], m[3]) for m in members]
    jpreds, _ = j_eval([(m[0], m[1]) for m in members], jl, jopt, mesh=make_mesh(2), **kw)
    plain, _ = t_eval(tm, tl, topt, **kw)
    meshed, _ = t_eval(tm, tl, topt, mesh=make_device_mesh(2, CPU2), **kw)
    assert len(meshed) == 8 and meshed == plain == jpreds


def test_eval_split_on_a_mesh_equals_no_mesh(tmp_path):
    """Beam 2 over [cpu, cpu]: the no-mesh predictions; the loss, the mean
    of the blocks' means, within rounding of the whole batch's and of the
    JAX eval_split on make_mesh(2)."""
    from recurrent_fusion_network_tpu.models import setup as j_model
    from recurrent_fusion_network_tpu.training.eval_split import eval_split as j_split
    from recurrent_fusion_network_torch.training.eval_split import eval_split as t_split

    jopt, topt, jl, tl = _loaders(tmp_path)
    _, jparams, tmodel, tparams = _fixture_members(jopt, topt, seeds=(4,), tied=(True,))[0]
    kw = dict(split="val", val_images_use=8, beam_size=2, language_eval_flag=False)
    jloss, jpreds, _ = j_split(j_model(jopt), jparams, jl, jopt, mesh=make_mesh(2), **kw)
    mloss, mpreds, _ = t_split(tmodel, tparams, tl, topt, mesh=make_device_mesh(2, CPU2),
                               **kw)
    tl = _loaders(tmp_path)[3]  # a fresh loader: a second pass reads other batches
    loss, preds, _ = t_split(tmodel, tparams, tl, topt, **kw)
    assert len(mpreds) == 8 and mpreds == preds == jpreds
    np.testing.assert_allclose(mloss, loss, rtol=1e-6)
    np.testing.assert_allclose(mloss, jloss, rtol=1e-5)
