"""The port's data path against the JAX package: `PairLoader` batches (the
producer thread and the spawn pool, shuffled epochs, drop_last, an infinite
stream across epoch boundaries, shards), a worker's exception reaching the
consumer and `close()`; the mapper's real-split branch on MP3D observation
pickles and ScanNet annotation pickles with their depth pngs, written by the
test; `simclr_augment`; and the TensorBoard writer's records.

Host code: every value must be equal, bit for bit.
"""
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest

from nopesac_tpu.data.augmentation import simclr_augment as jax_simclr_augment
from nopesac_tpu.data.loader import PairLoader as JaxPairLoader
from nopesac_tpu.data.mapper import PairMapper as JaxPairMapper
from nopesac_tpu.data.synthetic import make_dataset as jax_make_dataset
from nopesac_tpu.utils import tb_writer as jax_tb

from nopesac_torch.data.augmentation import simclr_augment
from nopesac_torch.data.loader import PairLoader
from nopesac_torch.data.mapper import PairMapper
from nopesac_torch.data.synthetic import make_dataset
from nopesac_torch.utils import tb_writer
from torch_cpu import SUBPROCESS_ENV, torch_threads  # noqa: F401  (CPU thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
NQ = 50


def assert_batches_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        if k == "meta":
            assert ours[k] == theirs[k]
        elif isinstance(ours[k], dict):
            assert sorted(ours[k]) == sorted(theirs[k])
            for t in ours[k]:
                assert ours[k][t].dtype == theirs[k][t].dtype, t
                np.testing.assert_array_equal(ours[k][t], theirs[k][t], err_msg=t)
        else:
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def _take(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _shm_names():
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("num_workers,num_shards", [(0, 1), (2, 1), (0, 2), (2, 2)])
def test_loader_batches_equal_jax(num_workers, num_shards):
    """5 pairs (shard 1 of 2: 2 pairs) in batches of 2 with drop_last: the
    infinite stream crosses several epoch boundaries, each epoch shuffled by
    its own seed; the pool's batches equal the JAX loader's thread ones."""
    kw = dict(batch_size=2, shuffle=True, drop_last=True, seed=3, infinite=True,
              num_shards=num_shards, shard_id=num_shards - 1)
    ours = PairLoader(make_dataset(5, 3, seed=4, h=H, w=W), PairMapper(NQ, (H, W)),
                      num_workers=num_workers, **kw)
    theirs = JaxPairLoader(jax_make_dataset(5, 3, seed=4, h=H, w=W),
                           JaxPairMapper(image_size=(H, W)), **kw)
    assert len(ours) == len(theirs) == (2 if num_shards == 1 else 1)
    got, want = _take(ours, 5), _take(theirs, 5)
    ours.close()
    theirs.close()
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
    # not every batch the same: the epochs are shuffled
    assert len({tuple(m["image_id0"] for m in b["meta"]) for b in got}) > 1


def test_loader_finite_epoch_keeps_the_tail_without_drop_last():
    kw = dict(batch_size=2, shuffle=False, drop_last=False, infinite=False)
    ours = list(PairLoader(make_dataset(3, 2, seed=1, h=H, w=W), PairMapper(NQ, (H, W)), **kw))
    theirs = list(JaxPairLoader(jax_make_dataset(3, 2, seed=1, h=H, w=W),
                                JaxPairMapper(image_size=(H, W)), **kw))
    assert [len(b["meta"]) for b in ours] == [2, 1]
    for a, b in zip(ours, theirs):
        assert_batches_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_error_reaches_the_consumer(num_workers):
    """The third pair cannot be mapped (an MP3D image_id without its
    house separator): after the batches before it, the consumer gets the
    mapper's error instead of waiting forever."""
    data = make_dataset(3, 2, seed=2, h=H, w=W)
    data[2]["0"]["image_id"] = "noseparator"
    loader = PairLoader(data, PairMapper(NQ, (H, W)), batch_size=1, shuffle=False,
                        num_workers=num_workers)
    got = []
    with pytest.raises(RuntimeError, match="producer failed") as err:
        for batch in loader:
            got.append(batch)
    assert isinstance(err.value.__cause__, ValueError) and got
    loader.close()


def test_loader_close_leaves_no_thread_and_no_ring():
    loader = PairLoader(make_dataset(4, 2, seed=5, h=H, w=W), PairMapper(NQ, (H, W)),
                        batch_size=2, infinite=True, num_workers=2)
    live = [iter(loader), iter(loader)]  # a training stream and a precise-BN pass
    first = [next(it) for it in live]
    assert_batches_equal(*first)  # each iterator has its own ring and stream
    rings = set(loader._rings)
    assert len(rings) == 2 and rings <= _shm_names()
    threads = [t for t, _ in loader._producers]
    loader.close()
    assert not any(t.is_alive() for t in threads) and loader._producers == []
    assert loader._pool is None and not loader._rings and loader._dataset_shm is None
    assert not rings & _shm_names()
    # close() may run in a producer thread (a __del__ there): no self-join
    t = threading.current_thread()
    loader._producers = [(t, threading.Event())]
    loader.close()


def test_worker_side_modules_import_no_torch():
    """What a spawned worker unpickles (the loader's functions, the mapper)
    imports numpy and PIL only, so no worker can touch CUDA."""
    code = ("import sys\n"
            "import nopesac_torch.data.loader, nopesac_torch.data.mapper\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=SUBPROCESS_ENV,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ mapper

def _write_png(path, arr):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _real_split_pair(tmp_path, kind, size, seed):
    """A pair whose masks, depth and intrinsics live in the dataset's own
    pickles (written here at `size`), its images in files."""
    rng = np.random.default_rng(seed)
    root = str(tmp_path) + os.sep
    h, w = size
    pair = {"rel_pose": {"position": [0.3, -0.1, 0.7], "rotation": [-0.9, 0.1, 0.3, 0.3]},
            "gt_corrs": [[0, 1], [1, 0], [2, 2]]}
    for v in ("0", "1"):
        sem = np.zeros((h, w), np.int32)
        for k, sid in enumerate((7, 3, 12)):  # ids not in annotation order
            sem[(k * h) // 4:((k + 2) * h) // 4, (k * w) // 5:((k + 3) * w) // 5] = sid
        depth = rng.uniform(0.5, 8.0, (h, w)).astype(np.float32)
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        anns = [{"plane": [float(x) for x in rng.normal(0, 1, 3)]} for _ in range(3)]
        if kind == "mp3d":
            image_id = f"house{seed}_img{v}"
            fname = os.path.join(root, "images", f"img{v}.png")
            with open(os.path.join(_mkdir(root, "observations", f"house{seed}"),
                                   f"img{v}.pkl"), "wb") as f:
                pickle.dump({"semantic_sensor": sem, "depth_sensor": depth}, f)
        else:
            image_id = f"scene{seed}-{v}0"
            fname = os.path.join(root, "scene", "color", f"{v}0.jpg")
            masks = [(sem == sid).astype(np.uint8) for sid in (7, 3, 12)]
            k = np.asarray([[300.0 + seed, 0, w / 2], [0, 310.0, h / 2], [0, 0, 1]])
            with open(os.path.join(_mkdir(root, "twoView_Anns", f"scene{seed}"),
                                   f"{v}0.pkl"), "wb") as f:
                pickle.dump({"plane_masks": masks, "camera_K": k}, f)
            _write_png(fname.replace("color", "depth").replace(".jpg", ".png"),
                       (depth * 1000).astype(np.uint16))
        _write_png(fname, rgb)
        pair[v] = {"image_id": image_id, "file_name": fname, "height": h, "width": w,
                   "annotations": anns}
    return root, pair


def _mkdir(*parts):
    path = os.path.join(*parts)
    os.makedirs(path, exist_ok=True)
    return path


@pytest.mark.parametrize("kind", ["mp3d", "scannet"])
@pytest.mark.parametrize("size", [(H, W), (2 * H, 2 * W)])
@pytest.mark.parametrize("augmentation", [False, True])
def test_mapper_real_split_pickles_equal_jax(tmp_path, kind, size, augmentation):
    """Masks (ascending semantic ids for MP3D, `plane_masks` for ScanNet),
    depth, k_inv, images and augmentation draws equal the JAX mapper's, at
    the mapper's size and resized from twice it."""
    root, pair = _real_split_pair(tmp_path, kind, size, seed=len(kind))
    kw = dict(dataset_kind=kind, root_dir=root, augmentation=augmentation, seed=9)
    ours = PairMapper(NQ, (H, W), **kw)
    theirs = JaxPairMapper(image_size=(H, W), num_queries=NQ, **kw)
    for aug_seed in (None, 11):
        a, b = ours(pair, aug_seed=aug_seed), theirs(pair, aug_seed=aug_seed)
        assert_batches_equal({k: v for k, v in a.items() if k != "meta"},
                             {k: v for k, v in b.items() if k != "meta"})
        assert a["meta"] == b["meta"]
    t = a["targets0"]
    assert t["gt_valid"].sum() == 3 and t["depth"].all()  # from the pickles
    if kind == "scannet":
        assert not np.array_equal(t["k_inv"], ours.k_inv)


@pytest.mark.parametrize("kind", ["mp3d", "scannet"])
@pytest.mark.parametrize("camera_cls_on", [True, False])
def test_mapper_camera_classification_equal_jax(tmp_path, kind, camera_cls_on):
    """MODEL.CAMERA_HEAD.CLASSIFICATION_ON keeps the pose quaternion's sign
    (here w < 0), and without it the sign is made canonical: the samples,
    metas included, equal the JAX mapper's, in training and in
    evaluation."""
    root, pair = _real_split_pair(tmp_path, kind, (H, W), seed=3)
    assert pair["rel_pose"]["rotation"][0] < 0
    kw = dict(dataset_kind=kind, root_dir=root, camera_cls_on=camera_cls_on)
    for is_train in (True, False):
        ours = PairMapper(NQ, (H, W), is_train=is_train, **kw)
        theirs = JaxPairMapper(image_size=(H, W), num_queries=NQ, is_train=is_train,
                               raw_uint8=not is_train, **kw)
        a, b = ours(pair), theirs(pair)
        assert a["meta"] == b["meta"]
        assert_batches_equal({k: v for k, v in a.items() if k != "meta"},
                             {k: v for k, v in b.items() if k != "meta"})
        assert (a["gt_pose"][3] < 0) == camera_cls_on


def test_mapper_without_pickles_falls_back_to_annotations_like_jax(tmp_path):
    """Pairs of the generator under an MP3D root with no observation for
    them: the annotations' masks and the in-memory depth, as in JAX."""
    pairs, jpairs = make_dataset(2, 3, seed=6, h=H, w=W), jax_make_dataset(2, 3, seed=6, h=H, w=W)
    ours = PairMapper(NQ, (H, W), root_dir=str(tmp_path))
    theirs = JaxPairMapper(image_size=(H, W), num_queries=NQ, root_dir=str(tmp_path))
    for a, b in zip(pairs, jpairs):
        sa, sb = ours(a), theirs(b)
        assert_batches_equal({k: v for k, v in sa.items() if k != "meta"},
                             {k: v for k, v in sb.items() if k != "meta"})


# ------------------------------------------------------------ augmentation

@pytest.mark.parametrize("seed", range(8))
def test_simclr_augment_bit_equal(seed):
    img = np.random.default_rng(100 + seed).uniform(0, 255, (H, W, 3)).astype(np.float32)
    ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):  # the generators stay in step
        a, b = simclr_augment(img, ours), jax_simclr_augment(img, theirs)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ours.random() == theirs.random()


# --------------------------------------------------------------- tb writer

def test_tb_writer_records_byte_equal(tmp_path, monkeypatch):
    """At a fixed wall_time both writers write the same bytes, which JAX's
    reader decodes (the CRCs included)."""
    monkeypatch.setattr(tb_writer.time, "time", lambda: 1700000000.25)
    paths = []
    for mod, sub in ((tb_writer, "port"), (jax_tb, "jax")):
        with mod.TBScalarWriter(str(tmp_path / sub)) as w:
            w.add_scalars({"total_loss": 1.5, "eval/mask_ap@0.5": 0.25, "nan": float("nan")},
                          step=3)
            w.add_scalars({"grad_norm": 7}, step=2 ** 40, wall_time=12.5)
        paths.append(w.path)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    events = jax_tb.read_tfevents(paths[0])
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[1] == {"step": 3, "scalars": {"total_loss": 1.5, "eval/mask_ap@0.5": 0.25},
                         "file_version": None}
    assert events[2]["step"] == 2 ** 40 and events[2]["scalars"] == {"grad_norm": 7.0}
    assert tb_writer.read_tfevents(paths[0]) == events
