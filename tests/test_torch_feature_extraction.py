"""The port's feature extraction vs the JAX package's, on the CPU: the 10
augmentation variants, adaptive pooling, the ResNet, DenseNet and Inception
backbones, the flat-npz weights, and the extract CLI.

Inputs and weights come from a numpy seed. The backbones get the same
weights both ways: a JAX tree through ``convert.backbone_params_from_jax``,
or one torchvision-layout state dict that both packages load. The
Inception parameters are a slim-named flat dict built with numpy from the
port's names and shapes (the JAX ``inception_init`` traces a whole 299 px
image eagerly, tens of seconds per arch on a CPU); the JAX trunk raises
KeyError for any name it reads that is missing, and the converter rejects
extras. The JAX forwards are jitted (eager, each op compiles on its own).
Tolerances, f32: rtol 1e-4 / atol 1e-5; a backbone's fc and att, whose
roundoff grows with the scale of the whole map through tens of layers of
random weights, rtol 1e-4 / atol 1e-5 x max(1, max |JAX output|); the
variants exactly equal.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch import feat_registry as t_registry
from recurrent_fusion_network_torch.convert import backbone_params_from_jax
from recurrent_fusion_network_torch.data import dataset as t_dataset
from recurrent_fusion_network_torch.data import sharded as t_sharded
from recurrent_fusion_network_torch.data.feature_extraction import augment as t_aug
from recurrent_fusion_network_torch.data.feature_extraction import backbones as t_bb
from recurrent_fusion_network_torch.data.feature_extraction import densenet as t_dn
from recurrent_fusion_network_torch.data.feature_extraction import extract as t_extract
from recurrent_fusion_network_torch.data.feature_extraction import inception as t_inc
from recurrent_fusion_network_torch.data.feature_extraction import resnet as t_rn
from recurrent_fusion_network_tpu.data.feature_extraction import augment as j_aug
from recurrent_fusion_network_tpu.data.feature_extraction import densenet_jax as j_dn
from recurrent_fusion_network_tpu.data.feature_extraction import extract as j_extract
from recurrent_fusion_network_tpu.data.feature_extraction import inception_jax as j_inc
from recurrent_fusion_network_tpu.data.feature_extraction import resnet_jax as j_rn

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _close_features(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def torchvision_state_dict(shapes, seed):
    """A torchvision-layout state dict for ``shapes`` (numpy seed): He-normal
    convs, random batch-norm statistics, and the entries the backbones do
    not read (a classifier, ``num_batches_tracked``)."""
    g = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        if len(shape) == 4:
            v = g.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith(("running_var", ".weight")):
            v = g.uniform(0.5, 1.5, shape)
        else:
            v = g.standard_normal(shape) * 0.1
        sd[name] = torch.from_numpy(v.astype(np.float32))
        if name.endswith("running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"] = torch.zeros(3, 2)
    sd["classifier.bias"] = torch.zeros(3)
    return sd


def slim_flat(arch, seed):
    """The slim-named flat dict of an Inception arch (HWIO conv weights, as
    the JAX package and its npz files hold them), from a numpy seed."""
    g = np.random.default_rng(seed)
    out = {}
    for name, shape in t_inc.param_shapes(arch).items():
        if name.endswith("/w"):
            o, i, kh, kw = shape
            v = g.standard_normal((kh, kw, i, o)) * np.sqrt(2.0 / (kh * kw * i))
        elif name.endswith(("bn/var", "bn/scale")):
            v = g.uniform(0.5, 1.5, shape)
        else:
            v = g.standard_normal(shape) * 0.1
        out[name] = v.astype(np.float32)
    return out


# --------------------------------------------------------------- variants


@pytest.mark.parametrize("variant", t_registry.VARIANTS)
def test_variant_equals_jax(variant):
    """The batched variant equals the JAX package's per-image loop exactly,
    on a non-square batch."""
    imgs = _images(0, (3, 17, 23, 3))
    got = t_aug.make_variant(torch.from_numpy(imgs), variant).numpy()
    want = np.stack([np.asarray(j_aug.make_variant(jnp.asarray(im), variant))
                     for im in imgs])
    np.testing.assert_array_equal(got, want)
    # one (H, W, C) image as well
    np.testing.assert_array_equal(
        t_aug.make_variant(torch.from_numpy(imgs[1]), variant).numpy(), want[1])


def test_crop_of_a_one_pixel_axis_samples_the_box_centre():
    imgs = _images(1, (2, 1, 9, 3))
    for variant in ("crop_br", "flip_crop_tl"):
        got = t_aug.make_variant(torch.from_numpy(imgs), variant).numpy()
        want = np.stack([np.asarray(j_aug.make_variant(jnp.asarray(im), variant))
                         for im in imgs])
        np.testing.assert_array_equal(got, want)
    assert t_aug.VARIANT_BOXES == j_aug.VARIANT_BOXES
    with pytest.raises(KeyError):
        t_aug.make_variant(torch.from_numpy(imgs), "crop_xx")


# ------------------------------------------------------------- backbones


@pytest.mark.parametrize("H, W, S", [(7, 7, 3), (5, 9, 2), (4, 4, 4), (2, 3, 5)])
def test_adaptive_pool_and_fc_equal_jax(H, W, S):
    """fc = the spatial mean; att = the map at S x S or torch's adaptive
    bins (the port) against the JAX package's ``_torch_adaptive_pool``."""
    x = _images(2, (2, H, W, 6))
    fc, att = t_rn.fc_att(torch.from_numpy(x).permute(0, 3, 1, 2), S)
    want = x if (H, W) == (S, S) else np.asarray(j_rn._torch_adaptive_pool(jnp.asarray(x), S))
    _close(att, want)
    _close(fc, x.mean(axis=(1, 2)))


TINY_RESNET = dict(blocks=(1, 1, 1, 1), width=8)
TINY_DENSENET = dict(blocks=(2, 2, 2, 2), growth=4, init_features=8)


def _tiny(arch, att_size):
    """(JAX config, port config, JAX features, port features)."""
    if arch == "resnet":
        return (j_rn.ResNetConfig(**TINY_RESNET, att_size=att_size),
                t_rn.ResNetConfig(**TINY_RESNET, att_size=att_size),
                j_rn.resnet_features, t_rn.resnet_features)
    return (j_dn.DenseNetConfig(**TINY_DENSENET, att_size=att_size),
            t_dn.DenseNetConfig(**TINY_DENSENET, att_size=att_size),
            j_dn.densenet_features, t_dn.densenet_features)


@pytest.mark.parametrize("arch", ["resnet", "densenet"])
@pytest.mark.parametrize("att_size", [2, 3])
def test_tiny_backbone_equals_jax_through_the_converter(arch, att_size):
    """A JAX tree (the JAX loader's, of a seeded state dict: the JAX init
    draws key by key, eagerly, for seconds on a CPU) through
    backbone_params_from_jax; 64 px images, the
    final map 2 x 2 (att_size 2: the map itself, 3: adaptive bins)."""
    jcfg, tcfg, jfeat, tfeat = _tiny(arch, att_size)
    tmod, jmod = (t_rn, j_rn) if arch == "resnet" else (t_dn, j_dn)
    jp = _np(jmod.load_torch_state_dict(torchvision_state_dict(tmod.param_shapes(tcfg), 3),
                                        jcfg))
    tp = backbone_params_from_jax(arch, jp)
    assert set(tp) == set(tmod.param_shapes(tcfg))
    x = _images(4, (2, 64, 64, 3))
    jfc, jatt = jax.jit(jfeat, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    tfc, tatt = tfeat(tp, torch.from_numpy(x), tcfg)
    assert tatt.shape == (2, att_size, att_size, jatt.shape[-1])
    _close_features(tfc, jfc)
    _close_features(tatt, jatt)


@pytest.mark.parametrize("arch", ["resnet", "densenet"])
def test_tiny_backbone_equals_jax_from_one_torchvision_state_dict(arch):
    """One torchvision-layout state dict (random BN statistics, a classifier
    and batch counters the backbones do not read) loaded by both packages."""
    jcfg, tcfg, jfeat, tfeat = _tiny(arch, 2)
    tmod, jmod = (t_rn, j_rn) if arch == "resnet" else (t_dn, j_dn)
    sd = torchvision_state_dict(tmod.param_shapes(tcfg), seed=5)
    jp = jmod.load_torch_state_dict(sd, jcfg)
    tp = tmod.load_torch_state_dict(sd, tcfg)
    assert set(tp) == set(tmod.param_shapes(tcfg))
    x = _images(6, (2, 64, 64, 3))
    jfc, jatt = jax.jit(jfeat, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    tfc, tatt = tfeat(tp, torch.from_numpy(x), tcfg)
    _close_features(tfc, jfc)
    _close_features(tatt, jatt)
    # the converter maps the JAX loader's tree onto the state dict's entries
    for name, v in backbone_params_from_jax(arch, _np(jp)).items():
        np.testing.assert_array_equal(v.numpy(), sd[name].numpy())
    del sd[next(iter(tmod.param_shapes(tcfg)))]
    with pytest.raises(KeyError):
        tmod.load_torch_state_dict(sd, tcfg)


@pytest.mark.parametrize("arch", ["inception_v3", "inception_v4", "inception_resnet_v2"])
def test_inception_trunk_equals_jax_at_75px(arch):
    """The smallest input the trunks take: a 1 x 1 att grid for all three."""
    flat = slim_flat(arch, seed=7)
    tp = backbone_params_from_jax(arch, flat)
    x = _images(8, (2, 75, 75, 3))
    jfc, jatt = jax.jit(lambda p, x: j_inc.inception_features(arch, p, x))(
        {k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(x))
    tfc, tatt = t_inc.inception_features(arch, tp, torch.from_numpy(x))
    _, fc_dim, att_dim = j_inc._TRUNKS[arch]
    assert tfc.shape == (2, fc_dim) and tatt.shape == (2, 1, 1, att_dim)
    _close_features(tfc, jfc)
    _close_features(tatt, jatt)


def test_flat_npz_loads_alike_and_the_converter_checks_names(tmp_path):
    """The JAX package's npz (HWIO) read by both loaders: the port's holds the
    JAX one's arrays, conv weights OIHW; build_backbone reads it. The
    converter refuses an extra or a missing name."""
    arch = "inception_v3"
    flat = slim_flat(arch, seed=9)
    path = str(tmp_path / "v3.npz")
    np.savez(path, **flat)
    jp, tp = j_inc.load_flat_npz(path), t_inc.load_flat_npz(path)
    assert set(jp) == set(tp) == set(t_inc.param_shapes(arch))
    conv = backbone_params_from_jax(arch, _np(jp))
    for k, v in tp.items():
        np.testing.assert_array_equal(v.numpy(), conv[k].numpy())
    params, _, fc_dim, att_dim = t_bb.build_backbone(arch, 8, path, device="cpu")
    assert (fc_dim, att_dim) == (2048, 1280)
    np.testing.assert_array_equal(params["Mixed_7c/Branch_3/Conv2d_0b_1x1/w"].numpy(),
                                  flat["Mixed_7c/Branch_3/Conv2d_0b_1x1/w"].transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="does not read"):
        backbone_params_from_jax(arch, {**flat, "Mixed_9z/w": flat["Conv2d_1a_3x3/w"]})
    missing = dict(flat)
    del missing["Mixed_6e/Branch_0/Conv2d_0a_1x1/bn/mean"]
    with pytest.raises(ValueError, match="not assigned"):
        backbone_params_from_jax(arch, missing)
    cfg = t_rn.ResNetConfig(**TINY_RESNET)
    jtree = _np(j_rn.load_torch_state_dict(torchvision_state_dict(t_rn.param_shapes(cfg), 0),
                                           j_rn.ResNetConfig(**TINY_RESNET)))
    jtree["layer2"][0]["conv2"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        backbone_params_from_jax("resnet50", jtree)


@pytest.mark.parametrize("arch, size, grid, fc_dim, att_dim", [
    ("resnet101", 448, 14, 2048, 2048), ("densenet161", 224, 7, 2208, 2208),
    ("inception_v3", 299, 8, 2048, 1280), ("inception_v4", 299, 8, 1536, 1536),
    ("inception_resnet_v2", 299, 8, 1536, 1536)])
def test_native_geometry_gives_the_registry_dims(arch, size, grid, fc_dim, att_dim):
    """The runbook's five encoders at their native geometry (a forward on
    the meta device): the registry's dims, and JAX's default geometry."""
    assert t_extract.default_geometry(arch) == j_extract.default_geometry(arch) == (size, grid)
    raw, shapes, fc, att = t_bb.trunk(arch, grid)
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    fc_shape, att_shape = t_bb.output_shapes(raw, meta, size)
    assert fc_shape == (1, fc_dim) and att_shape == (1, grid, grid, att_dim)
    assert (fc, att) == (fc_dim, att_dim)
    name = arch.split("1")[0] if arch.startswith(("resnet", "densenet")) else arch
    info = t_registry.encoder_info(name, "unused")
    assert (info.fc_feat_size, info.att_feat_size, info.att_num) == (fc_dim, att_dim, grid ** 2)


def test_build_backbone_is_seeded_and_names_its_archs(capsys):
    assert t_bb.ARCHS == j_extract.ARCHS
    a, feats, fc_dim, att_dim = t_bb.build_backbone("resnet50", 2, device="cpu")
    assert "WARNING: random backbone weights" in capsys.readouterr().out
    b, _, _, _ = t_bb.build_backbone("resnet50", 2, device="cpu")
    c, _, _, _ = t_bb.build_backbone("resnet50", 2, seed=1, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    before = torch.backends.cudnn.allow_tf32
    fc, att = feats(a, torch.zeros(1, 64, 64, 3))
    assert fc.shape == (1, fc_dim) and att.shape == (1, 2, 2, att_dim) and not fc.requires_grad
    assert torch.backends.cudnn.allow_tf32 == before  # scoped to the call
    with pytest.raises(ValueError, match="arch not supported"):
        t_bb.build_backbone("vgg16", 7, device="cpu")
    for name in ("COCO_val2014_000000391895.jpg", "123.png", "x_7.jpeg"):
        assert t_extract.image_id_from_name(name) == j_extract.image_id_from_name(name)


# ------------------------------------------------------------ extract CLI

N_IMAGES = 6
SIZES = [(40, 52), (64, 64), (30, 70), (64, 48), (51, 51), (90, 33)]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """6 seeded PNGs of mixed sizes with COCO names."""
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    g = np.random.default_rng(11)
    for i, (h, w) in enumerate(SIZES):
        arr = (g.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"COCO_val2014_{4000 + i:012d}.png")
    return d


@pytest.fixture(scope="module")
def resnet50_weights(tmp_path_factory):
    """A torchvision-layout resnet50 state dict on disk (the JAX CLI builds
    resnet50 at its published width)."""
    path = tmp_path_factory.mktemp("weights") / "resnet50.pth"
    torch.save(torchvision_state_dict(t_rn.param_shapes(t_rn.ResNetConfig.resnet50()), 13),
               path)
    return str(path)


def _cli(images, out, *extra):
    return ["--images_dir", str(images), "--output_dir", str(out), "--arch", "resnet50",
            "--image_size", "64", "--att_size", "2", "--batch_size", "4", *extra]


def test_extract_cli_packed_rows_equal_jax(images, resnet50_weights, tmp_path):
    """resnet50 (published width) at 64 px, the 10 variants, the same
    torchvision weights: every packed row of the port's CLI against the JAX
    CLI's, the same ids, and a store the loader reads."""
    common = ("--variants", "all", "--torch_weights", resnet50_weights)
    j_extract.main(_cli(images, tmp_path / "jax", *common))
    t_extract.main(_cli(images, tmp_path / "port", *common, "--device", "cpu"))
    ids = json.load(open(tmp_path / "port" / "ids.json"))
    assert ids == json.load(open(tmp_path / "jax" / "ids.json")) == list(range(4000, 4006))
    for v in t_registry.VARIANTS:
        for kind, shape in (("fc", (N_IMAGES, 2048)), ("att", (N_IMAGES, 4, 2048))):
            got = np.load(tmp_path / "port" / f"{v}_{kind}.npy")
            assert got.shape == shape and got.dtype == np.float32
            _close_features(got, np.load(tmp_path / "jax" / f"{v}_{kind}.npy"))
    fc, att = t_dataset.PackedFeatureSource(str(tmp_path / "port")).load(4003, "flip_crop_bl")
    assert fc.shape == (2048,) and att.shape == (4, 2048)


def test_extract_sharded_equals_packed(images, resnet50_weights, tmp_path):
    common = ("--variants", "original,crop_tr", "--torch_weights", resnet50_weights,
              "--device", "cpu")
    t_extract.main(_cli(images, tmp_path / "packed", *common))
    t_extract.main(_cli(images, tmp_path / "sharded", *common, "--output_format", "sharded",
                        "--shard_size", "4"))
    assert not (tmp_path / "sharded.packed_tmp").exists()
    packed = t_dataset.PackedFeatureSource(str(tmp_path / "packed"))
    sharded = t_sharded.ShardedFeatureSource(str(tmp_path / "sharded"))
    for image_id in range(4000, 4006):
        for v in ("original", "crop_tr"):
            for a, b in zip(packed.load(image_id, v), sharded.load(image_id, v)):
                np.testing.assert_array_equal(a, b)


def test_extract_resumes_after_sigterm_to_the_same_bytes(images, monkeypatch, tmp_path):
    """SIGTERM while the middle chunk decodes: the marker stops there, ids.json
    is gone; the same command again finishes to the bytes of an
    uninterrupted run. A signal on the final chunk completes the run."""
    common = ("--variants", "original,flip", "--batch_size", "2", "--device", "cpu")
    t_extract.main(_cli(images, tmp_path / "ref", *common))
    out = tmp_path / "out"
    t_extract.main(_cli(images, out, *common))
    assert (out / "ids.json").exists()
    (out / "progress.json").unlink()  # a fresh restart over a complete directory
    real = t_extract.load_image
    seen = {"ids_at_first_load": None}

    def sigterm_on(fname):
        def load(path, size):
            if seen["ids_at_first_load"] is None:
                seen["ids_at_first_load"] = (out / "ids.json").exists()
            if os.path.basename(path) == fname:
                os.kill(os.getpid(), signal.SIGTERM)
            return real(path, size)
        return load

    monkeypatch.setattr(t_extract, "load_image", sigterm_on("COCO_val2014_000000004002.png"))
    t_extract.main(_cli(images, out, *common))
    assert seen["ids_at_first_load"] is False and not (out / "ids.json").exists()
    assert json.load(open(out / "progress.json"))["done"] == 4
    monkeypatch.setattr(t_extract, "load_image", sigterm_on("COCO_val2014_000000004005.png"))
    t_extract.main(_cli(images, out, *common))
    assert json.load(open(out / "progress.json"))["done"] == N_IMAGES
    for name in ("original_fc.npy", "original_att.npy", "flip_fc.npy", "flip_att.npy",
                 "ids.json"):
        assert (out / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name


def test_extract_rejects_the_geometry_before_any_io(images, tmp_path):
    out = tmp_path / "packed"
    with pytest.raises(SystemExit, match="att grid"):
        t_extract.main(["--images_dir", str(images), "--output_dir", str(out), "--arch",
                        "inception_v3", "--image_size", "299", "--att_size", "14",
                        "--device", "cpu"])
    assert not out.exists()
