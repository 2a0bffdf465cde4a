"""Dataset registration: MP3D / ScanNet sparse-view pair splits and the
synthetic smoke splits (the port's own copy of the reference registration,
data/datasets/builtin.py and data/datasets/mp3d.py).

Each pair dict has keys "0"/"1" (per-view: file_name, image_id, height,
width, annotations[{bbox, bbox_mode, category_id, segmentation, plane}]),
"rel_pose" {position[3], rotation[4]}, and "gt_corrs" [[i, j], ...].
"""
from __future__ import annotations

import json
import os
from typing import List

from .registry import DatasetCatalog, MetadataCatalog
from .synthetic import make_dataset

PLANE_METADATA = [{"name": "plane", "color": [230, 25, 75], "id": 1}]

SPLITS = {
    "mp3d_val": ("mp3d", "mp3d_planercnn_json/cached_set_val.json"),
    "mp3d_test": ("mp3d", "mp3d_planercnn_json/cached_set_test.json"),
    "mp3d_train": ("mp3d", "mp3d_planercnn_json/cached_set_train.json"),
    "scannet_train": ("scannet", "scannet_json/cached_set_trainV2.json"),
    "scannet_test": ("scannet", "scannet_json/cached_set_testV2.json"),
}

_DATA_ROOTS = {
    "mp3d": "./datasets/mp3d_dataset/",
    "scannet": "./datasets/scannet_dataset/",
}


def dataset_kind(name: str) -> str:
    """The layout of a split's files, by its name: "scannet" or "mp3d"."""
    return "scannet" if "scannet" in name else "mp3d"


def load_pair_json(json_file: str, dataset_name: str | None = None) -> List[dict]:
    with open(json_file) as f:
        summary = json.load(f)
    if dataset_name is not None:
        cats = summary.get("categories", [])
        if cats:
            MetadataCatalog.set(
                dataset_name,
                thing_classes=[c["name"] for c in sorted(cats, key=lambda x: x["id"])],
            )
    return summary["data"]


def register_pair_dataset(dataset_name: str, json_rel: str, root: str | None = None) -> None:
    if "mp3d" in dataset_name:
        root = root or _DATA_ROOTS["mp3d"]
    elif "scannet" in dataset_name:
        root = root or _DATA_ROOTS["scannet"]
    else:
        raise NotImplementedError(dataset_name)

    json_file = os.path.join(root, json_rel)
    DatasetCatalog.register(dataset_name,
                            lambda: load_pair_json(json_file, dataset_name),
                            allow_overwrite=True)
    MetadataCatalog.set(
        dataset_name,
        json_file=json_file,
        image_root=root,
        evaluator_type="mp3d",
        thing_classes=[m["name"] for m in PLANE_METADATA],
        thing_colors=[m["color"] for m in PLANE_METADATA],
        thing_dataset_id_to_contiguous_id={m["id"]: i for i, m in enumerate(PLANE_METADATA)},
    )


def _register_synthetic() -> None:
    """Synthetic smoke splits from `data/synthetic.py`: random planes and
    exact relative poses, no files on disk (`DATASETS.TEST
    '("synthetic_test",)'`)."""
    for name, (n_pairs, seed) in {
        "synthetic_train": (8, 0),
        "synthetic_test": (4, 100),
    }.items():
        if name in DatasetCatalog:
            continue

        def gen(n_pairs=n_pairs, seed=seed):
            return make_dataset(n_pairs=n_pairs, n_planes=4, h=96, w=128, seed=seed)

        DatasetCatalog.register(name, gen)
        MetadataCatalog.set(
            name,
            json_file="",
            image_root="",
            evaluator_type="mp3d",
            thing_classes=[m["name"] for m in PLANE_METADATA],
            thing_colors=[m["color"] for m in PLANE_METADATA],
            thing_dataset_id_to_contiguous_id={m["id"]: i for i, m in enumerate(PLANE_METADATA)},
        )


def register_builtin(root_override: str | None = None) -> None:
    """Register the builtin splits. An explicit root_override re-registers
    every split under the new root (the module-level call below registered
    them with the default roots at import time)."""
    for name, (kind, rel) in SPLITS.items():
        if name in DatasetCatalog and root_override is None:
            continue
        register_pair_dataset(name, rel, root_override)
    _register_synthetic()


register_builtin()
