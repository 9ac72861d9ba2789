"""Raw images to captions, the port vs the JAX package on the CPU:
``eval_image_folder``, ``CaptionService.caption_image`` / ``POST
/caption_image``, and the eval --image_folder and serve --backbone_weights
CLIs.

Both packages get the same captioner (the JAX init through
``params_from_jax``) and the same backbone weights (one torchvision-layout
state dict both load), at 64 px with tiny captioners. Tolerances: tokens
and captions identical; the sentence log-prob rtol 1e-4 / atol 1e-5.
"""

import http.client
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from recurrent_fusion_network_torch import config as t_config
from recurrent_fusion_network_torch import eval as t_eval_cli
from recurrent_fusion_network_torch import serve as t_serve
from recurrent_fusion_network_torch.convert import params_from_jax
from recurrent_fusion_network_torch.data.feature_extraction import backbones as t_bb
from recurrent_fusion_network_torch.data.feature_extraction import extract as t_extract
from recurrent_fusion_network_torch.data.feature_extraction import resnet as t_rn
from recurrent_fusion_network_torch.decoding import http_serve as t_http
from recurrent_fusion_network_torch.models import setup as t_model
from recurrent_fusion_network_torch.training.eval_folder import eval_image_folder as t_folder
from recurrent_fusion_network_tpu.config import Options as JaxOptions
from recurrent_fusion_network_tpu.data.feature_extraction import resnet_jax as j_rn
from recurrent_fusion_network_tpu.decoding.http_serve import CaptionService as JaxService
from recurrent_fusion_network_tpu.models import setup as j_model
from recurrent_fusion_network_tpu.training import checkpoint as j_ckpt
from recurrent_fusion_network_tpu.training.eval_folder import eval_image_folder as j_folder

from test_torch_feature_extraction import torchvision_state_dict

V = 30
VOCAB = {str(i): f"w{i}" for i in range(1, V + 1)}
SIZES = [(40, 52), (64, 64), (30, 70)]


def _models(caption_model, encoders, seed=0, **over):
    """(JAX model, port model, JAX params, port params) of a tiny captioner
    over ``encoders`` [(fc, att, att_num)]."""
    kw = dict(caption_model=caption_model, rnn_size=16, input_encoding_size=16,
              att_hid_size=16, num_review_steps=2, num_review_steps_0=2, top_words_count=6,
              feat_array_info=[{"fc_feat_size": f, "att_feat_size": a, "att_num": n}
                               for f, a, n in encoders], **over)
    jopt = JaxOptions(feature_type="synthetic", **kw)
    topt = t_config.Options(**kw)
    topt.tied_att_keys = jopt.tied_att_keys
    for o in (jopt, topt):
        o.vocab_size, o.seq_length = V, 6
    jm, tm = j_model(jopt), t_model(topt)
    jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    return jm, tm, jp, params_from_jax(jp)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """3 seeded images of mixed sizes (PNG and JPEG), numeric names."""
    d = tmp_path_factory.mktemp("imgs")
    g = np.random.default_rng(21)
    for i, (h, w) in enumerate(SIZES):
        arr = (g.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"{i + 1}.{'jpg' if i == 2 else 'png'}")
    return d


@pytest.fixture(scope="module")
def resnet50_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "resnet50.pth"
    torch.save(torchvision_state_dict(t_rn.param_shapes(t_rn.ResNetConfig.resnet50()), 23),
               path)
    return str(path)


@pytest.mark.parametrize("caption_model, seed", [("review_net", 3),
                                                 ("recurrent_fusion_model", 1)])
def test_eval_image_folder_equals_jax(caption_model, seed, images, resnet50_weights):
    """resnet50 (published width, shared weights) at 64 px, a 2 x 2 grid; a
    ReviewNet, and a one-encoder RFNet whose stream is wrapped in a list
    (captioner seeds whose captions differ from image to image, so that
    equal captions hold the features). The JAX side pads its last batch;
    the port's runs the real rows."""
    jm, tm, jp, tp = _models(caption_model, [(2048, 2048, 4)], seed=seed)
    kw = dict(beam_size=3, batch_size=2, image_size=64, backbone_arch="resnet50", att_size=2,
              backbone_weights=resnet50_weights)
    want = j_folder(jm, jp, VOCAB, str(images), **kw)
    got = t_folder(tm, tp, VOCAB, str(images), device="cpu", **kw)
    assert got == want
    assert [p["image_id"] for p in got] == [1, 2, 3] and all(p["caption"] for p in got)
    assert len({p["caption"] for p in got}) > 1


def test_multi_encoder_models_are_refused_alike(images):
    """A 3-encoder RFNet: eval_image_folder and a service with a backbone
    refuse it with the JAX package's message."""
    jm, tm, _, tp = _models("recurrent_fusion_model", [(2048, 2048, 4), (8, 8, 4), (8, 8, 4)])
    kw = dict(backbone_arch="resnet50", att_size=2, image_size=64)
    with pytest.raises(ValueError, match="encoder streams") as j_err:
        j_folder(jm, None, VOCAB, str(images), **kw)
    with pytest.raises(ValueError, match="encoder streams") as t_err:
        t_folder(tm, tp, VOCAB, str(images), device="cpu", **kw)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="single-encoder") as j_err:
        JaxService(jm, None, VOCAB, backbone=(None, None, 64))
    with pytest.raises(ValueError, match="single-encoder") as t_err:
        t_http.CaptionService(tm, tp, VOCAB, device="cpu", backbone=(None, None, 64))
    assert str(t_err.value) == str(j_err.value)


def test_caption_image_equals_jax_with_the_default_resample(images):
    """A tiny resnet backbone (one shared state dict) and ReviewNet behind
    both services: each image's caption and log-prob, and the port's HTTP
    route. The upload is resized with PIL's default resample, as the JAX
    service does, not the extract CLI's BILINEAR."""
    cfg = dict(blocks=(1, 1, 1, 1), width=8, att_size=2)
    jcfg, tcfg = j_rn.ResNetConfig(**cfg), t_rn.ResNetConfig(**cfg)
    sd = torchvision_state_dict(t_rn.param_shapes(tcfg), 25)
    jm, tm, jp, tp = _models("review_net", [(256, 256, 4)], seed=1)
    jsvc = JaxService(jm, jp, VOCAB, batch_size=2, beam_size=3,
                      backbone=(j_rn.load_torch_state_dict(sd, jcfg),
                                lambda p, x: j_rn.resnet_features(p, x, jcfg), 64))
    tsvc = t_http.CaptionService(
        tm, tp, VOCAB, device="cpu", batch_size=2, beam_size=3,
        backbone=(t_rn.load_torch_state_dict(sd, tcfg),
                  lambda p, x: t_rn.resnet_features(p, x, tcfg), 64))
    httpd = t_http.run_server(tsvc, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        for path in sorted(images.iterdir()):
            body = path.read_bytes()
            want, got = jsvc.caption_image(body), tsvc.caption_image(body)
            assert got["caption"] == want["caption"] and got["caption"]
            np.testing.assert_allclose(got["logprob"], want["logprob"], rtol=1e-4, atol=1e-5)
            conn.request("POST", "/caption_image", body=body)
            r = conn.getresponse()
            assert r.status == 200 and json.loads(r.read()) == got
            arr = t_http.decode_image_bytes(body, 64)
            default = np.asarray(Image.open(path).convert("RGB").resize((64, 64)), np.float32)
            np.testing.assert_array_equal(arr[0], default / 255.0)
            if Image.open(path).size != (64, 64):
                assert not np.array_equal(arr[0], t_extract.load_image(str(path), 64))
        conn.request("POST", "/caption_image", body=b"not an image")
        r = conn.getresponse()
        assert r.status == 400 and "error" in json.loads(r.read())
        conn.close()
    finally:
        httpd.shutdown()
        tsvc.close()
        jsvc.close()
        httpd.server_close()


def test_caption_image_without_a_backbone_answers_500(images):
    _, tm, _, tp = _models("review_net", [(256, 256, 4)])
    svc = t_http.CaptionService(tm, tp, VOCAB, device="cpu", batch_size=2)
    httpd = t_http.run_server(svc, "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/caption_image", body=(images / "1.png").read_bytes())
        r = conn.getresponse()
        assert r.status == 500 and "without a backbone" in json.loads(r.read())["error"]
        conn.close()
    finally:
        httpd.shutdown()
        svc.close()
        httpd.server_close()


@pytest.fixture
def resnet_triple(tmp_path):
    """A JAX-written ReviewNet triple on the registry's resnet features (fc
    2048, att 196 x 2048), what raw-image captioning feeds."""
    jopt = JaxOptions(caption_model="review_net", feature_type="resnet", rnn_size=16,
                      input_encoding_size=16, att_hid_size=16, num_review_steps=2,
                      top_words_count=6)
    jopt.vocab_size, jopt.seq_length = V, 6
    params = j_model(jopt).init_params(jax.random.PRNGKey(7))
    j_ckpt.save_checkpoint(str(tmp_path), "img", 0, params=params, opt_state=None,
                           infos={"opt": dict(vars(jopt)), "vocab": VOCAB}, best=True)
    return str(tmp_path)


def test_eval_cli_captions_an_image_folder(resnet_triple, images, capsys):
    """eval --image_folder: a resnet101 backbone at 448 px (random weights,
    the JAX package's fixed geometry) into the triple's ReviewNet; one
    file<TAB>caption line per image."""
    preds = t_eval_cli.main(["--device", "cpu", "--model_path", resnet_triple,
                             "--load_model_id", "img", "--image_folder", str(images),
                             "--beam_size", "3", "--batch_size", "2",
                             "--backbone_arch", "densenet161"])
    out = capsys.readouterr().out
    assert "WARNING: random backbone weights" in out
    assert [p["file"] for p in preds] == ["1.png", "2.png", "3.jpg"]
    for p in preds:
        assert f"{p['file']}\t{p['caption']}\n" in out
        assert p["caption"] and all(w in VOCAB.values() for w in p["caption"].split())


def test_serve_cli_builds_the_backbone_at_448(resnet_triple, images, resnet50_weights):
    """serve --backbone_weights: the named arch at 448 px with a 14 x 14
    grid, as the JAX serve CLI builds it; /caption_image answers."""
    svc = t_serve.build_service(t_config.parse_serve_opt([
        "--model_path", resnet_triple, "--load_model_id", "img", "--device", "cpu",
        "--serve_dtype", "float32", "--beam_size", "3", "--serve_batch_size", "2",
        "--backbone_weights", resnet50_weights, "--backbone_arch", "resnet50"]))
    try:
        params, feats, size = svc.backbone
        assert size == 448 and set(params) == set(t_rn.param_shapes(t_rn.ResNetConfig.resnet50()))
        out = svc.caption_image((images / "3.jpg").read_bytes())
        assert out["caption"] and np.isfinite(out["logprob"])
    finally:
        svc.close()
    assert t_serve.build_service(t_config.parse_serve_opt([
        "--model_path", resnet_triple, "--load_model_id", "img", "--device", "cpu"])
    ).backbone is None


def test_raw_image_entry_points_raise_without_cuda(images, resnet_triple, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tm, _, tp = _models("review_net", [(2048, 2048, 4)])
    for make in (
        lambda: t_extract.main(["--images_dir", str(images), "--output_dir",
                                str(tmp_path / "out")]),
        lambda: t_eval_cli.main(["--model_path", resnet_triple, "--load_model_id", "img",
                                 "--image_folder", str(images)]),
        lambda: t_serve.main(["--model_path", resnet_triple, "--load_model_id", "img",
                              "--backbone_weights", "w.pth"]),
        lambda: t_bb.build_backbone("resnet50", 2),
        lambda: t_folder(tm, tp, VOCAB, str(images)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert not (tmp_path / "out").exists()
