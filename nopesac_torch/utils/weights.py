"""Weights of the port: carry-over from the JAX package's parameter trees, and
a seeded random initialisation.

`state_dict_from_jax` is the inverse of the JAX package's
`utils/torch_import.py:import_torch_weights`: it takes the Flax `params` and
`batch_stats` trees (nested dicts of numpy arrays) and returns the port's
`state_dict`, whose names and layouts are the reference torch checkpoint's.
It unstacks the scanned `layers`/`pairs` axes, packs q/k/v into `in_proj`,
maps HWIO convs to OIHW and [in, out] linears to [out, in], undoes the NHWC
flatten of the camera fc layers, and maps BN statistics to
`running_mean`/`running_var`.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..models.camera_head import pose_grid
from ..models.resnet import STAGE_BLOCKS
# torch Sequential index of each conv of the camera conv stacks (the pools
# of convs_backbone take indices 2 and 5)
_CAM_STACKS = {"convs_backbone": (0, 1, 3, 4, 6, 7), "convs_trans": tuple(range(6)),
               "convs_rots": tuple(range(6))}
_PIXEL_DECODER = {"layer_3": "layer_res5", "adapter_2": "adapter_res4", "layer_2": "layer_res4",
                  "adapter_1": "adapter_res3", "layer_1": "layer_res3"}
_CAM_MLPS = ("rot_emb_proj", "trans_emb_proj", "geo_encoder", "geo_proj_s1", "decoder_rot",
             "geo_proj_s2", "decoder_tran", "decoder_rot2", "decoder_tran2",
             "normal_score_proj", "param_score_proj")


def _conv(k: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.transpose(k, (3, 2, 0, 1))


def _lin(k: np.ndarray) -> np.ndarray:
    """[in, out] -> [out, in]."""
    return np.transpose(k, (1, 0))


def state_dict_from_jax(params: Mapping, batch_stats: Mapping | None = None,
                        image_size: Sequence[int] = (480, 640)) -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) -> the port's state_dict. `image_size` fixes
    the (h, w) grid of the camera fc layers' NCHW flatten."""
    sd: Dict[str, torch.Tensor] = {}
    bs = batch_stats or {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    def frozen_bn(key, node):
        put(f"{key}.weight", node["scale"])
        put(f"{key}.bias", node["bias"])
        put(f"{key}.running_mean", node["mean"])
        put(f"{key}.running_var", node["var"])

    def conv_bn(key, pnode, snode):  # Sequential(conv, bn, act)
        put(f"{key}.0.weight", _conv(pnode["Conv_0"]["kernel"]))
        put(f"{key}.1.weight", pnode["BatchNorm_0"]["scale"])
        put(f"{key}.1.bias", pnode["BatchNorm_0"]["bias"])
        if snode:
            put(f"{key}.1.running_mean", snode["BatchNorm_0"]["mean"])
            put(f"{key}.1.running_var", snode["BatchNorm_0"]["var"])
        else:
            n = pnode["BatchNorm_0"]["scale"].shape[0]
            put(f"{key}.1.running_mean", np.zeros(n))
            put(f"{key}.1.running_var", np.ones(n))

    def dense(key, node, i=None):
        k = node["kernel"] if i is None else node["kernel"][i]
        put(f"{key}.weight", _lin(k))
        if "bias" in node:
            put(f"{key}.bias", node["bias"] if i is None else node["bias"][i])

    def layer_norm(key, node, i=None):
        put(f"{key}.weight", node["scale"] if i is None else node["scale"][i])
        put(f"{key}.bias", node["bias"] if i is None else node["bias"][i])

    def mlp(key, node):
        for name in sorted(node, key=lambda s: int(s.split("_")[1])):
            dense(f"{key}.layers.{name.split('_')[1]}", node[name])

    def conv(key, node):
        put(f"{key}.weight", _conv(node["kernel"]))
        if "bias" in node:
            put(f"{key}.bias", node["bias"])

    # ---- backbone
    bb = params["backbone"]
    put("backbone.stem.conv1.weight", _conv(bb["stem_conv1"]["kernel"]))
    frozen_bn("backbone.stem.conv1.norm", bb["stem_bn1"])
    for stage, n in enumerate(STAGE_BLOCKS, start=2):
        for b in range(n):
            src, dst = bb[f"res{stage}_{b}"], f"backbone.res{stage}.{b}"
            for ci in (1, 2, 3):
                put(f"{dst}.conv{ci}.weight", _conv(src[f"conv{ci}"]["kernel"]))
                frozen_bn(f"{dst}.conv{ci}.norm", src[f"bn{ci}"])
            if "shortcut_conv" in src:
                put(f"{dst}.shortcut.weight", _conv(src["shortcut_conv"]["kernel"]))
                frozen_bn(f"{dst}.shortcut.norm", src["shortcut_bn"])

    # ---- PlaneTR head
    if "plane_head" in params:
        ph, ph_bs = params["plane_head"], bs.get("plane_head", {})
        hp = "sem_seg_head"
        conv(f"{hp}.input_proj", ph["input_proj"])
        put(f"{hp}.query_embed.weight", ph["query_embed"])
        stacks = (("context_SA", "context_sa", (("self_attn", "self_attn"),)),
                  ("context2plane_decoder", "decoder",
                   (("self_attn", "self_attn"), ("multihead_attn", "cross_attn"))))
        for tname, jname, attns in stacks:
            lay = ph[jname]["layers"]["layer"]
            n_layers = lay["linear1"]["kernel"].shape[0]
            for i in range(n_layers):
                dst = f"{hp}.{tname}.layers.{i}"
                for tattn, jattn in attns:
                    a = lay[jattn]
                    qkv = ("q_proj", "k_proj", "v_proj")
                    put(f"{dst}.{tattn}.in_proj_weight",
                        np.concatenate([_lin(a[p]["kernel"][i]) for p in qkv]))
                    put(f"{dst}.{tattn}.in_proj_bias",
                        np.concatenate([a[p]["bias"][i] for p in qkv]))
                    dense(f"{dst}.{tattn}.out_proj", a["out_proj"], i)
                dense(f"{dst}.linear1", lay["linear1"], i)
                dense(f"{dst}.linear2", lay["linear2"], i)
                for norm in ("norm1", "norm2", "norm3"):
                    if norm in lay:
                        layer_norm(f"{dst}.{norm}", lay[norm], i)
            layer_norm(f"{hp}.{tname}.norm", ph[jname]["norm"])
        for tdn in ("top_down", "top_down_depth"):  # top_down_depth with MODEL.DEPTH_ON
            if tdn not in ph:
                continue
            td, td_bs = ph[tdn], ph_bs.get(tdn, {})
            for name in ("c1_conv", "c2_conv", "c3_conv", "c4_conv", "up_conv1", "up_conv2",
                         "up_conv3"):
                conv_bn(f"{hp}.{tdn}.{name}", td[name], td_bs.get(name))
            conv_bn(f"{hp}.{tdn}.m_conv_dict.m4", td["m4_conv"], td_bs.get("m4_conv"))
        if "depth" in ph:
            conv(f"{hp}.depth", ph["depth"])
        for name in ("plane_embedding", "plane_param", "plane_center"):
            mlp(f"{hp}.{name}", ph[name])
        dense(f"{hp}.plane_prob", ph["plane_prob"])
        conv(f"{hp}.pixel_embedding", ph["pixel_embedding"])
        conv(f"{hp}.pixel_plane_center", ph["pixel_plane_center"])

    # ---- matching head
    if "matching_head" in params:
        mh = params["matching_head"]
        for tname, jname in (("planeApp_proj", "plane_app_proj"),
                             ("planeDesc_proj", "plane_desc_proj")):
            put(f"matching_head.{tname}.weight", _lin(mh[jname]["kernel"])[:, :, None])
            put(f"matching_head.{tname}.bias", mh[jname]["bias"])
        put("matching_head.bin_score", mh["bin_score"])
        pairs = mh["gnn"]["pairs"]
        n_pairs = pairs["self_layer"]["q_proj"]["kernel"].shape[0]
        for i in range(n_pairs):
            for role, off in (("self_layer", 0), ("cross_layer", 1)):
                src, dst = pairs[role], f"matching_head.gnn.layers.{2 * i + off}"
                for tname, jname in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                                     ("v_proj", "v_proj"), ("merge", "merge"),
                                     ("mlp.0", "mlp1"), ("mlp.2", "mlp2")):
                    dense(f"{dst}.{tname}", src[jname], i)
                layer_norm(f"{dst}.norm1", src["norm1"], i)
                layer_norm(f"{dst}.norm2", src["norm2"], i)

    # ---- camera head
    if "camera_head" in params:
        ch, ch_bs = params["camera_head"], bs.get("camera_head", {})
        cp = "camera_head_list.0"
        pd = ch["pixel_decoder"]
        for tname, jname in _PIXEL_DECODER.items():
            put(f"{cp}.pixel_decoder.{tname}.weight", _conv(pd[jname]["Conv_0"]["kernel"]))
            put(f"{cp}.pixel_decoder.{tname}.norm.weight", pd[jname]["GroupNorm_0"]["scale"])
            put(f"{cp}.pixel_decoder.{tname}.norm.bias", pd[jname]["GroupNorm_0"]["bias"])
        conv(f"{cp}.pixel_decoder.mask_features", pd["mask_features"])
        for sname, idxs in _CAM_STACKS.items():
            for ci, ti in enumerate(idxs):
                conv_bn(f"{cp}.{sname}.{ti}", ch[sname][f"conv{ci}"],
                        ch_bs.get(sname, {}).get(f"conv{ci}"))
        _, (gh, gw) = pose_grid(*image_size)
        for fc in ("fc_trans", "fc_rots"):
            k = ch[fc]["kernel"]  # [h*w*c (NHWC flatten), out]
            if k.shape[0] != 128 * gh * gw:
                raise ValueError(f"{fc} takes {k.shape[0]} inputs, image size {tuple(image_size)} "
                                 f"gives 128x{gh}x{gw}")
            w4 = _lin(k).reshape(k.shape[1], gh, gw, 128)
            put(f"{cp}.{fc}.weight", np.transpose(w4, (0, 3, 1, 2)).reshape(k.shape[1], -1))
            put(f"{cp}.{fc}.bias", ch[fc]["bias"])
        for name in ("trans", "rots", "rot_score_reg", "trans_score_reg"):
            if name in ch:
                dense(f"{cp}.{name}", ch[name])
        for name in _CAM_MLPS:
            if name in ch:
                mlp(f"{cp}.{name}", ch[name])
    return sd


def seeded_init(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights from one torch.Generator, with the JAX package's init
    rules: xavier-uniform conv/linear weights (each third of a packed
    in_proj on its own) and zero biases, unit norm scales, N(0, 1) query
    embeddings, bin_score 1, and torch's default U(+-1/sqrt(fan_in)) for the
    shared pose regressors `trans`/`rots` (weight and bias)."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, bound):
        return torch.rand(shape, generator=gen) * (2 * bound) - bound

    def xavier(shape):
        recept = math.prod(shape[2:]) if len(shape) > 2 else 1
        return uniform(shape, math.sqrt(6.0 / ((shape[0] + shape[1]) * recept)))

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
            if owner in ("trans", "rots") and ".camera_head_list." in f".{name}":
                new = uniform(p.shape, 1.0 / math.sqrt(256))
            elif leaf == "in_proj_weight":
                new = torch.cat([xavier((p.shape[1], p.shape[1])) for _ in range(3)])
            elif name.endswith("query_embed.weight"):
                new = torch.randn(p.shape, generator=gen)
            elif leaf == "bin_score":
                new = torch.ones(p.shape)
            elif p.dim() >= 2:
                new = xavier(tuple(p.shape))
            elif leaf == "bias" or leaf == "in_proj_bias":
                new = torch.zeros(p.shape)
            else:  # norm scales
                new = torch.ones(p.shape)
            p.copy_(new.to(p.dtype))
    return model
