"""The port's visualisation (`engine/vis.py`, `visualization/vis2d.py`,
`utils/mesh.py`, `utils/np_geometry.py`) against the JAX package and the
root `vis_NopeSAC.py` on the same inputs.

Host numpy in float64 on both sides: vertices, faces, colours and UVs agree
to 1e-12 (they are bit-equal), the OBJ, MTL and PLY files byte for byte (the
OBJ comment line names its writer: `nopesac_torch` for the port), and the
2D figures and the plane textures pixel for pixel (the same PIL, matplotlib
and OpenCV calls).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vis_NopeSAC as jax_vis
from nopesac_tpu.utils import mesh as jax_mesh
from nopesac_tpu.utils import np_geometry as jax_geo
from nopesac_tpu.visualization import vis2d as jax_vis2d

from nopesac_torch.config.config import get_cfg
from nopesac_torch.data.registry import DatasetCatalog
from nopesac_torch.data.synthetic import make_dataset
from nopesac_torch.engine import vis
from nopesac_torch.engine.test import EvalRunner, build_eval_model
from nopesac_torch.utils import mesh, np_geometry
from nopesac_torch.visualization import vis2d
from torch_cpu import SUBPROCESS_ENV, torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
TOL = 1e-12


def warp_fixtures():
    """test_vis_mesh.py's two textured fixtures at 48x64: (masks, planes,
    image, step)."""
    h, w = 48, 64
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    masks = np.zeros((2, h, w), np.uint8)
    masks[0, 8:24, 8:30] = 1
    masks[1, 30:44, 34:60] = 1
    ramp = np.zeros((h, w, 3), np.uint8)
    ramp[:, :, 0] = (np.arange(w)[None, :] * 4).astype(np.uint8)
    mask = np.zeros((1, h, w), bool)
    mask[0, 10:30, 10:40] = True
    return [(masks, np.array([[0.0, 0.0, 2.0], [0.3, -0.2, 1.8]]), image, 2),
            (mask, np.array([[0.0, 0.0, 2.0]]), ramp, 1)]


def assert_mesh_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if a[key] is None:
            assert b[key] is None, key
        elif key == "texture":
            assert b[key].dtype == np.uint8
            np.testing.assert_array_equal(b[key], a[key])
        else:
            assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
            np.testing.assert_allclose(b[key], a[key], rtol=0, atol=TOL, err_msg=key)


def same_files(ours, theirs, names):
    """OBJ/MTL/PLY bytes equal, but for the writer's name in the OBJ comment."""
    for name in names:
        with open(os.path.join(ours, name), "rb") as f:
            a = f.read().replace(b"# nopesac_torch mesh:", b"# nopesac_tpu mesh:")
        with open(os.path.join(theirs, name), "rb") as f:
            assert a == f.read(), name


def png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_np_geometry_equals_the_jax_package():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(np_geometry.SUNCG_TO_HABITAT, jax_geo.SUNCG_TO_HABITAT)
    for hw in ((480, 640), (96, 128)):
        a, b = jax_geo.get_coordinate_map(*hw), np_geometry.get_coordinate_map(*hw)
        assert b.dtype == a.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    k = np.array([[400.0, 0, 60], [0, 410, 50], [0, 0, 1]])
    np.testing.assert_array_equal(np_geometry.get_coordinate_map(96, 128, k),
                                  jax_geo.get_coordinate_map(96, 128, k))
    q = rng.normal(size=(5, 4))
    np.testing.assert_array_equal(np_geometry.quat_to_rotmat(q), jax_geo.quat_to_rotmat(q))
    np.testing.assert_array_equal(np_geometry.quat_conjugate(q), jax_geo.quat_conjugate(q))
    # every pivot of Shepperd's construction: w, x, y and z largest
    for qq in ([0.9, 0.1, 0.2, 0.3], [0.1, 0.9, 0.2, 0.3], [0.1, 0.2, 0.9, 0.3],
               [0.1, 0.2, 0.3, 0.9]):
        m = jax_geo.quat_to_rotmat(np.asarray(qq) / np.linalg.norm(qq))
        np.testing.assert_array_equal(np_geometry.rotmat_to_quat(m), jax_geo.rotmat_to_quat(m))
    planes, t = rng.normal(size=(6, 3)), rng.normal(size=3)
    for fn in ("plane_params_to_global", "plane_params_to_local"):
        np.testing.assert_array_equal(getattr(np_geometry, fn)(planes, t, q[0]),
                                      getattr(jax_geo, fn)(planes, t, q[0]))
    a1, a2, a3 = rng.uniform(-30, 30, size=(3, 4))
    np.testing.assert_array_equal(np_geometry.rotmat_from_euler_deg(a1, a2, a3),
                                  jax_geo.rotmat_from_euler_deg(a1, a2, a3))


def test_meshes_equal_the_jax_package():
    rng = np.random.default_rng(1)
    kmap = np_geometry.get_coordinate_map(H, W)
    image = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    masks = np.zeros((3, H, W), np.uint8)
    masks[0, 8:40, 10:60] = 1
    masks[1, 50:90, 20:120] = 1
    masks[2, 0:2, 0:2] = 1  # under 3 points at steps 2 and 4: no mesh
    planes = np.array([[0.1, 0.2, 2.0], [0.4, -0.3, 1.5], [0.0, 0.0, 1.0]])
    for step in (1, 2, 4):
        a = jax_mesh.planes_to_meshes(masks, planes, kmap, image, step=step)
        b = mesh.planes_to_meshes(masks, planes, kmap, image, step=step)
        assert len(a) == len(b) == (3 if step == 1 else 2)
        for x, y in zip(a, b):
            assert_mesh_equal(x, y)
    a = jax_mesh.planes_to_meshes(masks, planes, kmap, None, step=2)
    b = mesh.planes_to_meshes(masks, planes, kmap, None, step=2)
    for x, y in zip(a, b):
        assert_mesh_equal(x, y)
    pos, rot = rng.normal(size=3), rng.normal(size=4)
    rot /= np.linalg.norm(rot)
    assert_mesh_equal(jax_mesh.transform_mesh(a[0], pos, rot), mesh.transform_mesh(b[0], pos, rot))
    assert_mesh_equal(jax_mesh.camera_frustum_mesh(pos, rot, color=(0.1, 0.2, 0.3)),
                      mesh.camera_frustum_mesh(pos, rot, color=(0.1, 0.2, 0.3)))
    parts = a + [jax_mesh.camera_frustum_mesh(pos, rot)]
    assert_mesh_equal(jax_mesh.join_meshes(parts), mesh.join_meshes(parts))
    assert_mesh_equal(jax_mesh.join_meshes([]), mesh.join_meshes([]))
    for hw in (None, (480, 640), (H, W)):
        for plane in planes:
            np.testing.assert_array_equal(mesh.plane_rectify_homography(plane, image_hw=hw),
                                          jax_mesh.plane_rectify_homography(plane, image_hw=hw))
    a = jax_mesh.planes_to_textured_meshes(masks, planes, kmap, image, step=2)
    b = mesh.planes_to_textured_meshes(masks, planes, kmap, image, step=2)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert_mesh_equal(x, y)


@pytest.mark.parametrize("fixture", [0, 1])
def test_texture_warp_against_cv2(fixture):
    """The plane textures that `cv2.warpPerspective` gives through the port
    equal, value for value, those it gives through the JAX package."""
    masks, planes, image, step = warp_fixtures()[fixture]
    kmap = np_geometry.get_coordinate_map(*image.shape[:2])
    a = jax_mesh.planes_to_textured_meshes(masks, planes, kmap, image, step=step)
    b = mesh.planes_to_textured_meshes(masks, planes, kmap, image, step=step)
    assert len(a) == len(b) == len(planes)
    for x, y in zip(a, b):
        assert_mesh_equal(x, y)
        assert y["texture"].shape == (300, 300, 3) and y["texture"].std() > 1.0


def test_writers_bytes_equal(tmp_path):
    rng = np.random.default_rng(2)
    kmap = np_geometry.get_coordinate_map(H, W)
    image = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    masks = np.zeros((2, H, W), np.uint8)
    masks[0, 10:50, 10:70] = 1
    masks[1, 40:90, 60:120] = 1
    planes = np.array([[0.2, 0.1, 2.0], [-0.5, 0.3, 1.2]])
    meshes = jax_mesh.planes_to_textured_meshes(masks, planes, kmap, image, step=4)
    meshes.append({**jax_mesh.camera_frustum_mesh([0, 0, 0], [1, 0, 0, 0]), "vert_colors": None})
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    joined = jax_mesh.join_meshes(meshes[:2])
    plain = {**joined, "vert_colors": None}
    for mod, d in ((mesh, ours), (jax_mesh, theirs)):
        mod.save_obj(str(d), "coloured", joined)
        mod.save_obj(str(d), "plain", plain)
        mod.save_ply(str(d / "coloured.ply"), joined)
        mod.save_ply(str(d / "plain.ply"), plain)
        mod.save_obj_textured(str(d), "textured", meshes)  # the same textures: PNGs equal too
    names = ["coloured.obj", "plain.obj", "coloured.ply", "plain.ply", "textured.obj",
             "textured.mtl", "textured_tex0.png", "textured_tex1.png"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == sorted(names)
    same_files(str(ours), str(theirs), names)
    with open(ours / "coloured.obj") as f:
        assert f.readline() == (f"# nopesac_torch mesh: {len(joined['verts'])} verts, "
                                f"{len(joined['faces'])} faces\n")


def test_vis2d_equals_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(vis2d._PALETTE, jax_vis2d._PALETTE)
    img0 = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    img1 = rng.integers(0, 255, size=(H, W + 16, 3), dtype=np.uint8)
    masks0 = np.zeros((3, H, W), np.uint8)
    masks0[0, 5:40, 5:60] = 1
    masks0[1, 50:90, 10:50] = 1
    masks0[2, 20:70, 70:120] = 1
    masks1 = np.zeros((2, H, W + 16), np.uint8)
    masks1[0, 10:60, 30:100] = 1
    masks1[1, 60:95, 90:140] = 1
    rles1 = [vis2d.rle_util.encode(m) for m in masks1]  # RLE input is decoded as well
    corrs = np.array([[0, 1], [2, 0]])
    for args in ((img0, masks0), (img0, masks0, 0.3, np.full((3, 3), 40, np.uint8))):
        np.testing.assert_array_equal(vis2d.get_labeled_seg(*args), jax_vis2d.get_labeled_seg(*args))
    np.testing.assert_array_equal(vis2d.mask_center(masks0[1]), jax_vis2d.mask_center(masks0[1]))
    np.testing.assert_array_equal(vis2d.mask_center(np.zeros((4, 4))), np.zeros(2))
    got = vis2d.draw_match(img0, img1, masks0, rles1, corrs)
    np.testing.assert_array_equal(got, jax_vis2d.draw_match(img0, img1, masks0, rles1, corrs))
    assert got.shape == (H, 2 * W + 16, 3)
    preds = [{"score": s, "category_id": 0, "segmentation": r}
             for s, r in zip((0.9, 0.05, 0.75), rles1 + rles1[:1])]
    a = jax_vis2d.create_instances(preds, (H, W), pred_planes=np.eye(3), conf_threshold=0.1)
    b = vis2d.create_instances(preds, (H, W), pred_planes=np.eye(3), conf_threshold=0.1)
    assert list(a) == list(b) and len(b["scores"]) == 2
    for key in a:
        np.testing.assert_array_equal(np.asarray(b[key], object), np.asarray(a[key], object))
    aff = rng.uniform(size=(7, 4)).astype(np.float32)
    matching = np.array([1, -1, 0, 3, -1, 2, -1])
    for mod, name in ((vis2d, "ours"), (jax_vis2d, "theirs")):
        mod.save_affinity(aff, str(tmp_path / f"{name}_raw.png"))
        mod.save_affinity_stitched(aff, 7, 4, matching, str(tmp_path / f"{name}_stitched.png"))
    for what in ("raw", "stitched"):
        np.testing.assert_array_equal(png(tmp_path / f"ours_{what}.png"),
                                      png(tmp_path / f"theirs_{what}.png"))


def vis_inputs(tmp_path, n_pairs=2, seed=3):
    """Predictions and optimized dicts of synthetic pairs with 6 planes per
    view (perturbed planes and cameras, a soft affinity, one-plane
    hypotheses), their renders written as PNGs the predictions name, and the
    pairs keyed as the vis CLI keys its GT."""
    from PIL import Image

    pairs = make_dataset(n_pairs=n_pairs, n_planes=6, h=H, w=W, seed=seed)
    rng = np.random.default_rng(seed)
    preds, ods = [], []
    for pair in pairs:
        pred = {}
        for v in ("0", "1"):
            view = pair[v]
            fname = str(tmp_path / f"{view['image_id']}.png")
            Image.fromarray(view["image"]).save(fname)
            planes = np.asarray([a["plane"] for a in view["annotations"]], np.float32)
            pred[v] = {"image_id": view["image_id"], "file_name": fname,
                       "instances": [{"score": 0.9, "category_id": 0,
                                      "segmentation": dict(a["segmentation"])}
                                     for a in view["annotations"]],
                       "pred_plane": torch.as_tensor(planes + rng.normal(scale=0.05, size=planes.shape)
                                                     .astype(np.float32))}
        gt = pair["rel_pose"]
        q = np.asarray(gt["rotation"]) + rng.normal(scale=0.05, size=4)
        pred["camera_onePP"] = {"pred": {"tran": rng.normal(size=(3, 3)),
                                         "rot": rng.normal(size=(3, 4))}}
        pred["pred_aff"] = rng.uniform(size=(6, 6)).astype(np.float32)
        preds.append(pred)
        ods.append({"best_camera": {"position": np.asarray(gt["position"]) + 0.1,
                                    "rotation": q / np.linalg.norm(q)},
                    "gt_camera": {"position": np.asarray(gt["position"]),
                                  "rotation": np.asarray(gt["rotation"])},
                    "best_assignment": np.eye(6)[rng.permutation(6)] * (rng.uniform(size=6) > 0.3)})
    return pairs, preds, ods


def obj_counts(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return (sum(line.startswith("v ") for line in lines),
            sum(line.startswith("f ") for line in lines))


def test_vis_pair_equals_vis_nopesac(tmp_path):
    """Every file of `vis_NopeSAC.vis_pair` and the port's on the same pair:
    meshes byte-equal, figures and textures pixel-equal; the OBJ counts are
    those of the meshes vis_pair returns."""
    pairs, preds, ods = vis_inputs(tmp_path)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    for idx, (pair, pred, od) in enumerate(zip(pairs, preds, ods)):
        jax_vis.vis_pair(idx, pred, od, str(theirs), H, W, gt_pair=pair, one_plane_cams=True)
        meshes = vis.vis_pair(idx, pred, od, str(ours), H, W, gt_pair=pair, one_plane_cams=True)
        for tag, m in meshes.items():
            parts = m if tag == "scene_textured" else [m]
            assert obj_counts(ours / f"{idx}_{tag}.obj") == (
                sum(len(p["verts"]) for p in parts), sum(len(p["faces"]) for p in parts)), tag
        assert len(meshes["scene_textured"]) == 12  # every plane of both views
    files = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == files
    per_pair = {"matching.png", "affinity_pred.png", "scene.obj", "scene_gt.obj",
                "scene_textured.obj", "scene_textured.mtl", "scene_gtplanes.obj",
                "cam_onePP0.obj", "cam_onePP1.obj", "cam_onePP2.obj", "cam_final.obj"}
    per_pair |= {f"scene_textured_tex{k}.png" for k in range(12)}
    assert set(files) == {f"{i}_{name}" for i in range(2) for name in per_pair}
    same_files(str(ours), str(theirs), [f for f in files if not f.endswith(".png")])
    for f in files:
        if f.endswith(".png"):
            np.testing.assert_array_equal(png(ours / f), png(theirs / f), err_msg=f)


def test_vis_cli_writes_vis_nopesac_files(tmp_path, monkeypatch):
    """`python -m nopesac_torch.engine.vis` on the port's own
    `engine/test.py` artifacts (synthetic_test at 96x128, the renders on
    disk) writes the files of `vis_NopeSAC.py`'s main on the same files."""
    from PIL import Image

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "smoke_synthetic.yaml"))
    cfg.merge_from_list(["TEST.EVAL_FULL_SCENE", "True", "OUTPUT_DIR", str(tmp_path / "eval")])
    cfg.freeze()
    EvalRunner(cfg, build_eval_model(cfg, device="cpu", seed=0)).test()
    pth = str(tmp_path / "eval" / "NopeSAC_instances_predictions.pth")
    cont = str(tmp_path / "eval" / "continuous.pkl")
    preds = vis.load_predictions(pth)
    renders = {v["image_id"]: v["image"] for p in DatasetCatalog.get("synthetic_test")
               for v in (p["0"], p["1"])}
    for p in preds:
        for v in ("0", "1"):
            p[v]["file_name"] = str(tmp_path / f"{p[v]['image_id']}.png")
            Image.fromarray(renders[p[v]["image_id"]]).save(p[v]["file_name"])
    torch.save(preds, pth)
    flags = ["--rcnn-cached-file", pth, "--optimized-dict-path", cont, "--num-data", "2",
             "--one-plane-cams", "--dataset-phase", "synthetic_test"]
    proc = subprocess.run([sys.executable, "-m", "nopesac_torch.engine.vis",
                           "--output-dir", str(tmp_path / "ours")] + flags,
                          cwd=REPO, env=SUBPROCESS_ENV, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setattr(sys, "argv", ["vis_NopeSAC.py", "--output-dir", str(tmp_path / "theirs")]
                        + flags)
    jax_vis.main()
    files = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == files
    for name in ("matching.png", "affinity_pred.png", "scene.obj", "scene_gt.obj",
                 "scene_textured.obj", "scene_gtplanes.obj", "cam_final.obj"):
        assert f"1_{name}" in files, name
    same_files(str(tmp_path / "ours"), str(tmp_path / "theirs"),
               [f for f in files if not f.endswith(".png")])
    for f in files:
        if f.endswith(".png"):
            np.testing.assert_array_equal(png(tmp_path / "ours" / f),
                                          png(tmp_path / "theirs" / f), err_msg=f)
