"""The port's host tools against the repo's `tools/` and the JAX package: the
ScanNet generator's geometry and file helpers
(`nopesac_torch/tools/generate_scannetv2_data.py`), `GeoConsistencyLoss`
(`nopesac_torch/tools/sparseplane_planeloss.py`), `rle.merge`, and the
weight loader's `.pkl` files and v1 keys (`engine/checkpoint.py`).

The tools are host numpy in both packages, the same float64 operations in
the same order, so their arrays are compared with `np.array_equal`.
`GeoConsistencyLoss`'s loss and distances are held within 1e-12 of the
JAX package's tool.
"""
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nopesac_tpu.config.config import get_cfg as jax_get_cfg
from nopesac_tpu.engine.trainer import build_model_from_cfg as jax_build_model
from nopesac_tpu.utils import rle as jax_rle
from nopesac_tpu.utils.torch_import import import_torch_weights
from tools import generate_scannetv2_data as jax_gen
from tools.sparseplane_planeloss import GeoConsistencyLoss as JaxGeoConsistencyLoss

from nopesac_torch.config.config import get_cfg
from nopesac_torch.engine.checkpoint import load_weights
from nopesac_torch.engine.predict import build_model_from_cfg
from nopesac_torch.tools import generate_scannetv2_data as gen
from nopesac_torch.tools.sparseplane_planeloss import GeoConsistencyLoss
from nopesac_torch.tools.synthetic_scans import write_scene
from nopesac_torch.utils import rle
from nopesac_torch.utils.np_geometry import quat_to_rotmat
from nopesac_torch.utils.weights import state_dict_from_jax
from torch_cpu import torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "inference_mp3d.yaml")
SEEDS = (0, 1, 2)
SHAPES = ((48, 64), (97, 130))


def _camera(rng, h, w):
    return np.array([rng.uniform(0.8, 1.2) * w, rng.uniform(0.8, 1.2) * w,
                     w / 2 + rng.normal(0, 3), h / 2 + rng.normal(0, 3)])


def _planes(rng, n):
    """Plane parameters in the generator's annotation frame (the permuted
    normal (x, -z, y) points away from the camera), 1.5-3.5 m away."""
    n_ = np.stack([rng.uniform(-0.3, 0.3, n), np.ones(n), rng.uniform(-0.3, 0.3, n)], -1)
    return n_ / np.linalg.norm(n_, axis=1, keepdims=True) * rng.uniform(1.5, 3.5, (n, 1))


def _pose(rng, deg=30.0, tran=0.8):
    q = np.concatenate([[1.0], rng.normal(0, np.deg2rad(deg) / 2, 3)])
    t = np.eye(4)
    t[:3, :3] = quat_to_rotmat(q / np.linalg.norm(q))
    t[:3, 3] = rng.normal(0, tran, 3)
    return t


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("max_depth", [10.0, 0.0])
def test_calc_plane_depths_equal_jax(seed, shape, max_depth):
    rng = np.random.default_rng(seed)
    h, w = shape
    planes, camera = _planes(rng, 5), _camera(rng, h, w)
    planes[0] *= -1  # behind the camera: clipped at 0, or negative without a clip
    got = gen.calc_plane_depths(planes, camera, w, h, max_depth=max_depth)
    want = jax_gen.calc_plane_depths(planes, camera, w, h, max_depth=max_depth)
    assert got.shape == (5, h, w) and np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_transform_planes_and_relative_pose_equal_jax(seed):
    rng = np.random.default_rng(seed)
    planes = rng.normal(0, 2, (7, 3))
    for t in (_pose(rng), np.eye(4)):
        assert np.array_equal(gen.transform_planes(t, planes), jax_gen.transform_planes(t, planes))
    e0, e1 = _pose(rng), _pose(rng)
    got, want = gen.relative_pose_habitat(e0, e1), jax_gen.relative_pose_habitat(e0, e1)
    assert got == want and got[1][0] >= 0  # lists of floats, w >= 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stride", [1, 8])
def test_view_overlap_ratio_equal_jax(seed, shape, stride):
    rng = np.random.default_rng(seed)
    h, w = shape
    depth = rng.uniform(1.0, 4.0, shape)
    depth[rng.uniform(size=shape) < 0.2] = 0.0
    camera, e0 = _camera(rng, h, w), _pose(rng)
    e1 = e0 @ _pose(rng, 20.0, 0.3)
    got = gen.view_overlap_ratio(depth, e0, e1, camera, stride=stride)
    assert got == jax_gen.view_overlap_ratio(depth, e0, e1, camera, stride=stride)
    assert 0.0 < got < 1.0
    assert gen.view_overlap_ratio(np.zeros(shape), e0, e1, camera) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_clean_segmentation_equal_jax(seed):
    """Confident and other labels, a segment whose depth disagrees with its
    plane, a thin one, a small one, a segment id past the labels, and dark
    pixels: the kept segments equal, and each rule drops something."""
    rng = np.random.default_rng(seed)
    h, w = 120, 160
    camera = _camera(rng, h, w)
    planes = _planes(rng, 7)
    seg = np.full((h, w), -1, np.int32)
    seg[:60, :80], seg[:60, 80:], seg[60:, :50], seg[60:, 50:110] = 0, 1, 2, 3
    seg[60:, 110:150], seg[60:64, 150:], seg[114:, 154:] = 4, 5, 6
    depth = np.take_along_axis(gen.calc_plane_depths(planes, camera, w, h),
                               np.maximum(seg, 0)[None], 0)[0]
    depth[seg == 3] += rng.uniform(0.2, 0.5)  # off its plane
    depth[rng.uniform(size=(h, w)) < 0.05] = 0.0  # holes
    image = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    image[:20, :20] = 5  # dark
    labels = [1, 5, 5, 5, 22, 5]  # segment 6 has no label
    kw = dict(plane_area_threshold=40, plane_width_threshold=5.0)
    got = gen.clean_segmentation(image, planes, labels, seg, depth, camera, **kw)
    want = jax_gen.clean_segmentation(image, planes, labels, seg, depth, camera, **kw)
    assert np.array_equal(got, want)
    assert set(np.unique(got)) == {-1, 0, 1, 2, 4}


# ---------------------------------------------------------- file helpers

@pytest.mark.parametrize("seed", SEEDS)
def test_segmentation_rgb_codec_equal_jax(seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-1, 1000, (37, 53)).astype(np.int32)
    rgb = gen.encode_segmentation_rgb(seg)
    assert rgb.dtype == np.uint8 and np.array_equal(rgb, jax_gen.encode_segmentation_rgb(seg))
    back = gen.decode_segmentation_rgb(rgb)
    assert np.array_equal(back, seg) and np.array_equal(back, jax_gen.decode_segmentation_rgb(rgb))
    white = np.full((2, 2, 3), 255, np.uint8)  # 0xFFFFFF is non-plane
    assert (gen.decode_segmentation_rgb(white) == -1).all()


def test_scene_info_and_pose_files_equal_jax(tmp_path):
    """`load_scene_info` and `read_pose` on a synthetic scene's files, a pose
    file of the wrong length and a scene without its meta file."""
    root = str(tmp_path)
    write_scene(root, "scene0007_00", n_frames=2, frame_step=20, seed=3, size=(48, 64))
    sp = os.path.join(root, "scene0007_00")
    got, want = gen.load_scene_info(sp), jax_gen.load_scene_info(sp)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k
        elif k == "plane_info":
            assert [p.tolist() for p in v] == [p.tolist() for p in want[k]]
        else:
            assert v == want[k], k
    assert got["num_images"] == 21 and got["camera_K"][0, 2] != 32.0
    pose = os.path.join(sp, "pose", "20.txt")
    assert np.array_equal(gen.read_pose(pose), jax_gen.read_pose(pose))
    with open(pose, "a") as f:
        f.write("1\n")
    assert gen.read_pose(pose) is None and jax_gen.read_pose(pose) is None
    os.remove(os.path.join(sp, "scene0007_00.txt"))
    assert gen.load_scene_info(sp) is None and jax_gen.load_scene_info(sp) is None


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", [20, 40])
def test_pose_gap_candidates_and_polygons_equal_jax(tmp_path, seed, step):
    """`candidate_pairs_by_pose_gap` at both splits' frame steps (both
    orders of each pair whose pose gap passes), and `_polygons_from_mask`
    on a scene's plane masks, an empty mask and a mask too small for a
    contour."""
    root = str(tmp_path)
    write_scene(root, "scene0007_00", n_frames=4, frame_step=step, seed=seed, size=(48, 64),
                planes=(4, 5))
    sp = os.path.join(root, "scene0007_00")
    n = gen.load_scene_info(sp)["num_images"]
    got = gen.candidate_pairs_by_pose_gap(sp, n, step)
    assert got == jax_gen.candidate_pairs_by_pose_gap(sp, n, step)
    # the cameras alternate sides: frames an odd number of steps apart pass
    assert sorted(got) == sorted((a * step, b * step) for a in range(4) for b in range(4)
                                 if (a - b) % 2)
    png = os.path.join(sp, "annotation", "segmentation", f"{step}.png")
    seg = gen.decode_segmentation_rgb(np.asarray(Image.open(png).convert("RGB")))
    dot = np.zeros((48, 64), np.uint8)
    dot[5, 7] = 1
    masks = [(seg == g).astype(np.uint8) for g in np.unique(seg)] + [np.zeros_like(dot), dot]
    for m in masks:
        got = gen._polygons_from_mask(m)
        assert got == jax_gen._polygons_from_mask(m)
    assert gen._polygons_from_mask(masks[0]) and gen._polygons_from_mask(dot) is None


def test_pairs_without_opencv_carry_rle_like_jax(tmp_path, monkeypatch):
    """Without OpenCV both generators write each plane's segmentation as
    COCO RLE, equal record for record, each the pickled plane mask."""
    root = str(tmp_path / "scans")
    # tests/test_torch_scannet.py's test scene
    write_scene(root, "scene0008_00", n_frames=3, frame_step=40, seed=3, size=(96, 128),
                planes=(4, 5))
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    sp = os.path.join(root, "scene0008_00")
    kw = dict(sample_step=40, max_hit_num=2)
    ours = gen.generate_scene_pairs(sp, anns_dir=str(tmp_path / "a"), **kw)
    theirs = jax_gen.generate_scene_pairs(sp, anns_dir=str(tmp_path / "b"), **kw)
    assert ours and json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    for rec in ours:
        for v in ("0", "1"):
            name = rec[v]["image_id"].split("-")[1] + ".pkl"
            with open(tmp_path / "a" / "scene0008_00" / name, "rb") as f:
                masks = pickle.load(f)["plane_masks"]
            for ann, m in zip(rec[v]["annotations"], masks, strict=True):
                seg = ann["segmentation"]
                assert isinstance(seg, dict) and seg["size"] == [96, 128]
                assert np.array_equal(rle.decode({"size": seg["size"],
                                                  "counts": seg["counts"].encode()}), m)


# ---------------------------------------------------- GeoConsistencyLoss

def _geo_inputs(seed, n_pairs, empty=False):
    rng = np.random.default_rng(seed)
    p1, p2, cams, batched = [], [], [], []
    for _ in range(n_pairs):
        n1, n2 = rng.integers(1, 8, 2)
        p1.append({"pred_plane": rng.normal(0, 2, (n1, 3))})
        p2.append(rng.normal(0, 2, (n2, 3)))  # a bare array is accepted too
        q = rng.normal(size=4)
        cams.append({"position": rng.normal(0, 1, 3), "rotation": q / np.linalg.norm(q)})
        k = 0 if empty else int(rng.integers(1, min(n1, n2) + 1))
        corrs = [[int(a), int(b)] for a, b in zip(rng.permutation(n1)[:k],
                                                   rng.permutation(n2)[:k])]
        batched.append({"gt_corrs": corrs + ([[n1 + 3, 0]] if not empty else [])})
    return batched, p1, p2, cams


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_pairs", [1, 4])
def test_geo_consistency_equal_jax(seed, n_pairs):
    batched, p1, p2, cams = _geo_inputs(seed, n_pairs)
    ours, theirs = GeoConsistencyLoss("cpu"), JaxGeoConsistencyLoss("cpu")
    got = ours(batched, p1, p2, cams, loss_weight=0.5)["geo_consistency_loss"]
    want = theirs(batched, p1, p2, cams, loss_weight=0.5)["geo_consistency_loss"]
    assert got > 0 and abs(got - want) <= 1e-12
    for distance in ("l2", "normal"):
        (a, n1, n2), (b, m1, m2) = (g.inference(p1, p2, cams, distance) for g in (ours, theirs))
        assert (n1, n2) == (m1, m2) and sorted(a) == sorted(b)
        for k in a:
            assert np.isfinite(a[k]).all()
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12, err_msg=k)
    with pytest.raises(NotImplementedError):
        ours.inference(p1, p2, cams, "cos")


def test_geo_consistency_without_correspondences_is_zero():
    batched, p1, p2, cams = _geo_inputs(5, 3, empty=True)
    assert GeoConsistencyLoss()(batched, p1, p2, cams) == {"geo_consistency_loss": 0.0}
    assert JaxGeoConsistencyLoss()(batched, p1, p2, cams) == {"geo_consistency_loss": 0.0}


# ------------------------------------------------------------ rle.merge

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("intersect", [False, True])
def test_rle_merge_byte_equal_jax(seed, intersect):
    rng = np.random.default_rng(seed)
    masks = [(rng.uniform(size=(30, 41)) < p).astype(np.uint8) for p in (0.3, 0.6, 0.8)]
    rles = [rle.encode(m) for m in masks]
    for group in (rles, rles[:1]):
        got, want = rle.merge(group, intersect), jax_rle.merge(group, intersect)
        assert got == want
    want_mask = masks[0] & masks[1] & masks[2] if intersect else masks[0] | masks[1] | masks[2]
    assert np.array_equal(rle.decode(rle.merge(rles, intersect)), want_mask)
    assert rle.merge([], intersect) == jax_rle.merge([], intersect) == {"size": [0, 0],
                                                                        "counts": b""}


# -------------------------------------------------------------- weights

@pytest.fixture(scope="module")
def jax_trees():
    """Zero-filled parameter and batch-stats trees of the JAX inference
    model (shapes from `jax.eval_shape`: nothing is compiled)."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(CONFIG)
    model = jax_build_model(cfg)
    x = jnp.zeros((1, 480, 640, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, out_h=480, out_w=640,
                                               method=model.inference))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return zeros["params"], zeros["batch_stats"]


@pytest.fixture(scope="module")
def port_state():
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    return cfg, build_model_from_cfg(cfg, device="cpu", seed=4).state_dict()


V1_KEY = "sem_seg_head.adapter_1.weight"  # tests/test_torch_import.py's v1 key


@pytest.mark.parametrize("v1", [False, True])
def test_pkl_weights_load_like_pth_and_into_jax(port_state, jax_trees, tmp_path, v1):
    """A seeded state_dict saved as .pkl loads into the port as the .pth
    does, strictly and as an overlay; the JAX importer reads the same .pkl
    and `state_dict_from_jax` of its trees gives back every tensor. With a
    v1 key both load: the port lists it as dropped, JAX leaves it unconsumed."""
    cfg, sd = port_state
    blob = dict(sd)
    if v1:
        blob[V1_KEY] = torch.ones(3)
    dropped = ["sem_seg_head.pixel_decoder.adapter_1.weight"] if v1 else []
    for suffix in (".pth", ".pkl"):
        path = str(tmp_path / f"model{suffix}")
        torch.save({"model": blob}, path)
        for strict in (True, False):
            model = build_model_from_cfg(cfg, device="cpu", seed=9)
            report = load_weights(model, path, strict=strict)
            assert report == {"missing": [], "unexpected": [], "dropped": dropped}
            for k, v in model.state_dict().items():
                assert torch.equal(v, sd[k]), k
        if suffix == ".pkl":
            params, stats, report = import_torch_weights(
                jax_trees[0], path, batch_stats=jax_trees[1], return_report=True)
            assert report["unconsumed"] == dropped
            back = state_dict_from_jax(params, stats, image_size=(480, 640))
            assert sorted(back) == sorted(sd)
            for k, v in back.items():
                assert torch.equal(v, sd[k]), k
        os.remove(path)


def test_unknown_keys_and_suffixes_still_raise(port_state, tmp_path):
    cfg, sd = port_state
    model = build_model_from_cfg(cfg, device="cpu", seed=9)
    torch.save({**sd, "sem_seg_head.predictor.extra": torch.ones(2)}, tmp_path / "bad.pkl")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_weights(model, str(tmp_path / "bad.pkl"))
    torch.save(sd, tmp_path / "model.bin")
    with pytest.raises(NotImplementedError, match=r"\.pth or \.pkl"):
        load_weights(model, str(tmp_path / "model.bin"))
    with pytest.raises(FileNotFoundError):
        load_weights(model, str(tmp_path / "missing.pkl"))
