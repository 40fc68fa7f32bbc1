"""Weight bridge: the JAX ``BEVDepth4D`` (and ``BEVDepth4DDistill``),
``BEVFormer`` and LiDAR-teacher (``CenterPoint``, ``DynamicCenterPoint``)
variables -> this port's ``state_dict``.

The port names its submodules as the reference mmdet3d state_dict, so
the correspondence is the one ``tools/model_converters/
convert_torch_ckpt.py:bevdepth4d_name_map`` describes (reference torch
name -> flax path).  This module keeps its own copy of that map and
walks it the other way, converting layouts: conv kernels HWIO -> OIHW,
Dense ``[in, out]`` -> ``[out, in]``, BatchNorm ``scale/bias`` and
``mean/var`` -> ``weight/bias`` and ``running_mean/running_var``,
LayerNorm ``scale`` -> ``weight``.  ``bevformer_name_map`` adds the
transformer: the deformable attentions' separate
``sampling_offsets_bias`` becomes their offset Linear's bias, the flax
multi-head attention's per-head query/key/value kernels become
``in_proj_weight``, and embeddings keep their layout.
``centerpoint_pillar_name_map`` and ``dynamic_centerpoint_name_map`` map
the teachers: the pillar encoders, SECOND, SECONDFPN (whose transposed
convs are flipped, see ``centerpoint_params_to_torch``) and the CenterHead.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

NameMap = Dict[str, Tuple[str, ...]]


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str,
                                                               np.ndarray]:
    """Nested ``{'params': ..., 'batch_stats': ...}`` -> ``{'params/a/b':
    array}`` with numpy leaves."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_variables(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def bn_name_map(torch_prefix: str, flax_path: Tuple[str, ...],
                stats_map: NameMap) -> NameMap:
    stats_map[f"{torch_prefix}.running_mean"] = flax_path + ("mean",)
    stats_map[f"{torch_prefix}.running_var"] = flax_path + ("var",)
    return {f"{torch_prefix}.weight": flax_path + ("scale",),
            f"{torch_prefix}.bias": flax_path + ("bias",)}


def resnet_name_map(depth: int, torch_prefix: str,
                    flax_prefix: Tuple[str, ...]) -> Tuple[NameMap,
                                                          NameMap]:
    """mmdet ResNet names -> the JAX ResNet paths."""
    blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
              101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    bottleneck = depth >= 50
    pm: NameMap = {}
    sm: NameMap = {}
    tp = torch_prefix
    pm[f"{tp}conv1.weight"] = flax_prefix + ("stem_conv", "kernel")
    pm.update(bn_name_map(f"{tp}bn1", flax_prefix + ("stem_bn",), sm))
    n_convs = 3 if bottleneck else 2
    for li, n in enumerate(blocks):
        for j in range(n):
            t_blk = f"{tp}layer{li + 1}.{j}"
            f_blk = flax_prefix + (f"layer{li + 1}_block{j}",)
            for ci in range(1, n_convs + 1):
                pm[f"{t_blk}.conv{ci}.weight"] = f_blk + (f"conv{ci}",
                                                          "kernel")
                pm.update(bn_name_map(f"{t_blk}.bn{ci}",
                                      f_blk + (f"bn{ci}",), sm))
            if j == 0 and (li > 0 or bottleneck):
                pm[f"{t_blk}.downsample.0.weight"] = f_blk + (
                    "downsample_conv", "kernel")
                pm.update(bn_name_map(f"{t_blk}.downsample.1",
                                      f_blk + ("downsample_bn",), sm))
    return pm, sm


def _bev_resnet_map(pm: NameMap, sm: NameMap, torch_prefix: str,
                    flax_prefix: Tuple[str, ...], num_layer):
    """ResNetForBEVDet ``layers.{i}.{j}`` -> ``stage{i}_block{j}``."""
    for i, n in enumerate(num_layer):
        for j in range(n):
            t_blk = f"{torch_prefix}layers.{i}.{j}"
            f_blk = flax_prefix + (f"stage{i}_block{j}",)
            for ci in (1, 2):
                pm[f"{t_blk}.conv{ci}.weight"] = f_blk + (f"conv{ci}",
                                                          "kernel")
                pm.update(bn_name_map(f"{t_blk}.bn{ci}",
                                      f_blk + (f"bn{ci}",), sm))
            if j == 0:
                pm[f"{t_blk}.downsample.weight"] = f_blk + (
                    "downsample_conv", "kernel")
                pm[f"{t_blk}.downsample.bias"] = f_blk + (
                    "downsample_conv", "bias")


def _center_head_map(pm: NameMap, sm: NameMap, num_tasks: int = 6,
                     keys=("reg", "height", "dim", "rot", "vel",
                           "heatmap"), head_convs: int = 2):
    pm["pts_bbox_head.shared_conv.conv.weight"] = (
        "bbox_head", "shared_conv", "conv", "kernel")
    pm.update(bn_name_map("pts_bbox_head.shared_conv.bn",
                          ("bbox_head", "shared_conv", "norm"), sm))
    for t in range(num_tasks):
        for key in keys:
            tk = f"pts_bbox_head.task_heads.{t}.{key}"
            for j in range(head_convs - 1):
                pm[f"{tk}.{j}.conv.weight"] = (
                    "bbox_head", f"task_{t}", f"{key}_conv{j}", "conv",
                    "kernel")
                pm.update(bn_name_map(
                    f"{tk}.{j}.bn",
                    ("bbox_head", f"task_{t}", f"{key}_conv{j}", "norm"),
                    sm))
            final = head_convs - 1
            pm[f"{tk}.{final}.weight"] = ("bbox_head", f"task_{t}",
                                          f"{key}_out", "kernel")
            pm[f"{tk}.{final}.bias"] = ("bbox_head", f"task_{t}",
                                        f"{key}_out", "bias")


def bevdepth4d_name_map(depth: int = 50) -> Tuple[NameMap, NameMap]:
    """Reference BEVDepth4D(Distill) student state_dict name -> flax path
    (params map, batch_stats map), as ``convert_torch_ckpt.py``."""
    pm, sm = resnet_name_map(depth, "img_backbone.", ("backbone",))
    for i in range(2):
        pm[f"img_neck.lateral_convs.{i}.conv.weight"] = (
            "neck", f"lateral_{i}", "kernel")
        pm[f"img_neck.lateral_convs.{i}.conv.bias"] = (
            "neck", f"lateral_{i}", "bias")
    pm["img_neck.fpn_convs.0.conv.weight"] = ("neck", "fpn_conv_0",
                                              "kernel")
    pm["img_neck.fpn_convs.0.conv.bias"] = ("neck", "fpn_conv_0", "bias")
    vt = "img_view_transformer."
    fvt = ("view_transformer",)
    for name in ("featnet", "depthnet"):
        pm[f"{vt}{name}.weight"] = fvt + (name, "kernel")
        pm[f"{vt}{name}.bias"] = fvt + (name, "bias")
    pm[f"{vt}se.input_conv.weight"] = fvt + ("se", "input_conv", "kernel")
    pm[f"{vt}se.input_conv.bias"] = fvt + ("se", "input_conv", "bias")
    pm[f"{vt}se.fc.1.weight"] = fvt + ("se", "fc", "kernel")
    pm[f"{vt}se.fc.1.bias"] = fvt + ("se", "fc", "bias")
    pm.update(bn_name_map(f"{vt}se.fc.0", fvt + ("se", "fc_bn"), sm))
    _bev_resnet_map(pm, sm, f"{vt}extra_depthnet.",
                    fvt + ("extra_depthnet",), [3])
    pm[f"{vt}dcn.0.weight"] = fvt + ("dcn_conv", "weight")
    pm[f"{vt}dcn.0.bias"] = fvt + ("dcn_conv", "bias")
    pm[f"{vt}dcn.0.conv_offset.weight"] = fvt + (
        "dcn_conv", "conv_offset", "kernel")
    pm[f"{vt}dcn.0.conv_offset.bias"] = fvt + (
        "dcn_conv", "conv_offset", "bias")
    pm.update(bn_name_map(f"{vt}dcn.1", fvt + ("dcn_bn",), sm))
    _bev_resnet_map(pm, sm, "img_bev_encoder_backbone.",
                    ("bev_backbone",), [2, 2, 2])
    neck = "img_bev_encoder_neck."
    pm[f"{neck}conv.0.weight"] = ("bev_neck", "conv0", "conv", "kernel")
    pm.update(bn_name_map(f"{neck}conv.1", ("bev_neck", "conv0", "norm"),
                          sm))
    pm[f"{neck}conv.3.weight"] = ("bev_neck", "conv1", "conv", "kernel")
    pm.update(bn_name_map(f"{neck}conv.4", ("bev_neck", "conv1", "norm"),
                          sm))
    pm[f"{neck}up2.1.weight"] = ("bev_neck", "up2_conv0", "conv",
                                 "kernel")
    pm.update(bn_name_map(f"{neck}up2.2",
                          ("bev_neck", "up2_conv0", "norm"), sm))
    pm[f"{neck}up2.4.weight"] = ("bev_neck", "up2_conv1", "kernel")
    pm[f"{neck}up2.4.bias"] = ("bev_neck", "up2_conv1", "bias")
    _bev_resnet_map(pm, sm, "pre_process_net.", ("pre_process_net",), [2])
    _center_head_map(pm, sm)
    return pm, sm


def _second_map(pm: NameMap, sm: NameMap, layer_nums):
    """SECOND ``blocks.{i}.{3j}`` (conv) / ``.{3j + 1}`` (BN) ->
    ``stage{i}_conv{j}``."""
    for i, n in enumerate(layer_nums):
        for j in range(n + 1):
            f = ("backbone", f"stage{i}_conv{j}")
            pm[f"pts_backbone.blocks.{i}.{3 * j}.weight"] = f + ("conv",
                                                                 "kernel")
            pm.update(bn_name_map(f"pts_backbone.blocks.{i}.{3 * j + 1}",
                                  f + ("norm",), sm))


def _second_fpn_map(pm: NameMap, sm: NameMap, neck: dict) -> NameMap:
    """SECONDFPN ``deblocks.{i}.0`` / ``.1`` -> ``deblock_{i}``; returns
    the transposed convs' entries, which take another layout."""
    transposed: NameMap = {}
    for i, st in enumerate(neck["upsample_strides"]):
        f = ("neck", f"deblock_{i}")
        kernel = f + ("deconv" if st > 1 else "conv", "kernel")
        if st > 1 or (st == 1 and not neck.get("use_conv_for_no_stride",
                                               False)):
            transposed[f"pts_neck.deblocks.{i}.0.weight"] = kernel
        else:
            pm[f"pts_neck.deblocks.{i}.0.weight"] = kernel
        pm.update(bn_name_map(f"pts_neck.deblocks.{i}.1", f + ("norm",), sm))
    return transposed


def _lidar_teacher_map(cfg: dict, pfn) -> Tuple[NameMap, NameMap, NameMap]:
    pm: NameMap = {}
    sm: NameMap = {}
    for i in range(len(cfg["pts_voxel_encoder"]["feat_channels"])):
        pfn(pm, sm, i)
    _second_map(pm, sm, cfg["pts_backbone"]["layer_nums"])
    transposed = _second_fpn_map(pm, sm, cfg["pts_neck"])
    head = cfg["pts_bbox_head"]
    convs = {int(v[1]) for v in head["common_heads"].values()}
    if convs != {2}:
        raise ValueError(f"head conv counts {convs}: the map takes 2")
    _center_head_map(pm, sm, num_tasks=len(head["tasks"]),
                     keys=tuple(head["common_heads"]) + ("heatmap",))
    return pm, sm, transposed


def centerpoint_pillar_name_map(cfg: dict) -> Tuple[NameMap, NameMap,
                                                    NameMap]:
    """Reference ``CenterPoint`` (PillarFeatureNet) state_dict name ->
    flax path for the model ``cfg``: (params map, batch_stats map, the
    transposed convs' params map)."""
    def pfn(pm, sm, i):
        t, f = f"pts_voxel_encoder.pfn_layers.{i}", ("voxel_encoder",
                                                    f"pfn_{i}")
        pm[f"{t}.linear.weight"] = f + ("linear", "kernel")
        pm.update(bn_name_map(f"{t}.norm", f + ("norm",), sm))
    return _lidar_teacher_map(cfg, pfn)


def dynamic_centerpoint_name_map(cfg: dict) -> Tuple[NameMap, NameMap,
                                                     NameMap]:
    """As ``centerpoint_pillar_name_map`` for ``DynamicCenterPoint`` and
    MVP: ``pfn_layers.{i}.0`` / ``.1`` -> ``linear_{i}`` / ``norm_{i}``."""
    def pfn(pm, sm, i):
        t = f"pts_voxel_encoder.pfn_layers.{i}"
        pm[f"{t}.0.weight"] = ("voxel_encoder", f"linear_{i}", "kernel")
        pm.update(bn_name_map(f"{t}.1", ("voxel_encoder", f"norm_{i}"), sm))
    return _lidar_teacher_map(cfg, pfn)


def centerpoint_params_to_torch(flat: Mapping[str, np.ndarray], cfg: dict
                                ) -> "OrderedDict[str, torch.Tensor]":
    """Flattened JAX ``CenterPoint`` / ``DynamicCenterPoint`` variables of
    the model ``cfg`` -> the port's state_dict.  A flax transposed conv
    ``[kh, kw, in, out]`` applies its kernel unflipped, torch's is the
    conv gradient: the kernel is flipped and becomes ``[in, out, kh,
    kw]`` (a 1x1 flax conv standing for a 1x1 transposed conv too)."""
    dynamic = cfg["pts_voxel_encoder"]["type"] == "DynamicPillarFeatureNet"
    pm, sm, transposed = (dynamic_centerpoint_name_map if dynamic
                          else centerpoint_pillar_name_map)(cfg)
    sd = map_to_state_dict(flat, pm, sm)
    for tname, path in transposed.items():
        key = "/".join(("params",) + path)
        if key not in flat:
            raise KeyError(f"{key} (for {tname}) not in the JAX variables")
        arr = np.asarray(flat[key], np.float32)[::-1, ::-1]
        sd[tname] = torch.from_numpy(arr.transpose(2, 3, 0, 1).copy())
    return sd


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if arr.ndim == 4:           # conv HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2 and leaf == "kernel":   # Dense -> Linear [out, in]
        return arr.transpose(1, 0)
    return arr


def jax_params_to_torch(flat: Mapping[str, np.ndarray],
                        depth: int = 50) -> "OrderedDict[str, torch.Tensor]":
    """Flattened JAX ``BEVDepth4D`` variables -> the port's state_dict.

    Args:
        flat: ``{'params/backbone/stem_conv/kernel': array,
            'batch_stats/backbone/stem_bn/mean': array, ...}``
            (``flatten_variables`` of ``{'params', 'batch_stats'}``).
        depth: the image ResNet's depth.

    Raises KeyError naming the first flax path the map needs and
    ``flat`` lacks.
    """
    return map_to_state_dict(flat, *bevdepth4d_name_map(depth))


_CONV_ADAPTATIONS = ("1x1conv", "3x3conv", "upsample_1x1conv",
                     "interpolate_1x1conv", "avgpool_1x1conv")


def bevdepth4d_distill_params_to_torch(flat: Mapping[str, np.ndarray],
                                       cfg: dict
                                       ) -> "OrderedDict[str, torch.Tensor]":
    """Flattened JAX ``BEVDepth4DDistill`` variables of the model ``cfg``
    -> the port's state_dict: the student (``jax_params_to_torch``, BN
    running statistics included) and the distiller's convolutional
    student adaptations and spatial adaptation convs; the teacher side
    must be ``identity``.  (The teacher itself takes
    ``centerpoint_params_to_torch``.)"""
    p = dict(cfg["distill_params"])
    n = len(p["student_channels"])
    kinds = p["adaptation_type"]
    kinds = [kinds] * n if isinstance(kinds, str) else list(kinds)
    t_kinds = p["teacher_adaptation_type"]
    t_kinds = [t_kinds] * n if isinstance(t_kinds, str) else list(t_kinds)
    pm, sm = bevdepth4d_name_map(cfg["img_backbone"].get("depth", 50))
    for i in range(n):
        if kinds[i] not in _CONV_ADAPTATIONS or t_kinds[i] != "identity":
            raise NotImplementedError(
                f"adaptations {kinds[i]!r} / {t_kinds[i]!r} have no map")
        _dense(pm, f"distiller.channel_wise_adaptations.{i}.conv",
               ("distiller", f"student_adapt_{i}", "conv"))
        if p.get("spatial_mask", True):
            _dense(pm, f"distiller.spatial_wise_adaptations.{i}",
                   ("distiller", f"spatial_adapt_{i}"))
    return map_to_state_dict(flat, pm, sm)


def map_to_state_dict(flat: Mapping[str, np.ndarray], pm: NameMap,
                      sm: NameMap) -> "OrderedDict[str, torch.Tensor]":
    """Fill a state_dict through a (params, batch_stats) name map."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for collection, name_map in (("params", pm), ("batch_stats", sm)):
        for tname, path in name_map.items():
            key = "/".join((collection,) + path)
            if key not in flat:
                raise KeyError(f"{key} (for {tname}) not in the JAX "
                               f"variables")
            arr = _to_torch_layout(np.asarray(flat[key], np.float32),
                                   path[-1])
            sd[tname] = torch.from_numpy(np.array(arr, copy=True))
    return sd


def _dense(pm: NameMap, tname: str, fpath: Tuple[str, ...],
           bias: bool = True):
    pm[f"{tname}.weight"] = fpath + ("kernel",)
    if bias:
        pm[f"{tname}.bias"] = fpath + ("bias",)


def _layer_norm(pm: NameMap, tname: str, fpath: Tuple[str, ...]):
    pm[f"{tname}.weight"] = fpath + ("scale",)
    pm[f"{tname}.bias"] = fpath + ("bias",)


def _deform_attn(pm: NameMap, tname: str, fpath: Tuple[str, ...],
                 output_proj: bool = True):
    pm[f"{tname}.sampling_offsets.weight"] = fpath + ("sampling_offsets",
                                                      "kernel")
    pm[f"{tname}.sampling_offsets.bias"] = fpath + ("sampling_offsets_bias",)
    for name in ("attention_weights", "value_proj") + (
            ("output_proj",) if output_proj else ()):
        _dense(pm, f"{tname}.{name}", fpath + (name,))


def _ffn_norms(pm: NameMap, tname: str, fpath: Tuple[str, ...]):
    _dense(pm, f"{tname}.ffns.0.layers.0.0", fpath + ("ffn", "fc1"))
    _dense(pm, f"{tname}.ffns.0.layers.1", fpath + ("ffn", "fc2"))
    for i in range(3):
        _layer_norm(pm, f"{tname}.norms.{i}", fpath + (f"norm{i + 1}",))


def _reg_branch(pm: NameMap, tname: str, fpath: Tuple[str, ...], lvl: int,
                num_reg_fcs: int = 2):
    for i in range(num_reg_fcs):
        _dense(pm, f"{tname}.{2 * i}", fpath + (f"reg_{lvl}_fc{i}",))
    _dense(pm, f"{tname}.{2 * num_reg_fcs}", fpath + (f"reg_{lvl}_out",))


def bevformer_name_map(cfg: dict) -> Tuple[NameMap, NameMap, Dict[str, Tuple[
        str, ...]]]:
    """Reference ``BEVFormer`` state_dict name -> flax path, for the model
    ``cfg`` (params map, batch_stats map, and the flax prefixes of the
    decoder self-attentions, whose query/key/value kernels merge into
    one ``in_proj``)."""
    bb, neck, head = cfg["img_backbone"], cfg["img_neck"], \
        cfg["pts_bbox_head"]
    tcfg = head["transformer"]
    pm, sm = resnet_name_map(bb.get("depth", 50), "img_backbone.",
                             ("backbone",))
    n_in = len(neck["in_channels"]) - neck.get("start_level", 0)
    for i in range(n_in):
        _dense(pm, f"img_neck.lateral_convs.{i}.conv", ("neck",
                                                        f"lateral_{i}"))
        _dense(pm, f"img_neck.fpn_convs.{i}.conv", ("neck", f"fpn_conv_{i}"))
    if neck.get("add_extra_convs"):
        for i in range(n_in, neck.get("num_outs", n_in)):
            _dense(pm, f"img_neck.fpn_convs.{i}.conv",
                   ("neck", f"extra_conv_{i}"))
    th, fh = "pts_bbox_head.", ("bbox_head",)
    pm[f"{th}bev_embedding.weight"] = fh + ("bev_embedding",)
    pm[f"{th}query_embedding.weight"] = fh + ("query_embedding",)
    for e in ("row_embed", "col_embed"):
        pm[f"{th}positional_encoding.{e}.weight"] = fh + (
            "positional_encoding", e)
    n_dec = tcfg["decoder"].get("num_layers", 6)
    for lvl in range(n_dec):
        for i in range(2):
            _dense(pm, f"{th}cls_branches.{lvl}.{3 * i}",
                   fh + (f"cls_{lvl}_fc{i}",))
            _layer_norm(pm, f"{th}cls_branches.{lvl}.{3 * i + 1}",
                        fh + (f"cls_{lvl}_ln{i}",))
        _dense(pm, f"{th}cls_branches.{lvl}.6", fh + (f"cls_{lvl}_out",))
        _reg_branch(pm, f"{th}reg_branches.{lvl}", fh, lvl)
    tt, ft = f"{th}transformer.", fh + ("transformer",)
    pm[f"{tt}level_embeds"] = ft + ("level_embeds",)
    pm[f"{tt}cams_embeds"] = ft + ("cams_embeds",)
    _dense(pm, f"{tt}reference_points", ft + ("reference_points",))
    _dense(pm, f"{tt}can_bus_mlp.0", ft + ("can_bus_fc1",))
    _dense(pm, f"{tt}can_bus_mlp.2", ft + ("can_bus_fc2",))
    _layer_norm(pm, f"{tt}can_bus_mlp.norm", ft + ("can_bus_norm",))
    for i in range(tcfg["encoder"].get("num_layers", 6)):
        tl, fl = f"{tt}encoder.layers.{i}", ft + ("encoder", f"layer_{i}")
        _deform_attn(pm, f"{tl}.attentions.0", fl + ("tsa",))
        _deform_attn(pm, f"{tl}.attentions.1.deformable_attention",
                     fl + ("sca", "deformable_attention"), output_proj=False)
        _dense(pm, f"{tl}.attentions.1.output_proj", fl + ("sca",
                                                           "output_proj"))
        _ffn_norms(pm, tl, fl)
    mha = {}
    for i in range(n_dec):
        tl, fl = f"{tt}decoder.layers.{i}", ft + ("decoder", f"layer_{i}")
        mha[f"{tl}.attentions.0.attn"] = fl + ("self_attn", "attn")
        _deform_attn(pm, f"{tl}.attentions.1", fl + ("cross_attn",))
        _ffn_norms(pm, tl, fl)
        if head.get("with_box_refine", True):
            _reg_branch(pm, f"{tt}decoder.reg_branches.{i}",
                        ft + ("decoder",), i)
    return pm, sm, mha


def unstack_scanned_layers(flat: Mapping[str, np.ndarray],
                           num_layers: int) -> Dict[str, np.ndarray]:
    """An encoder built with ``scan_layers=True`` stacks its layers'
    variables under ``encoder/layers`` with a leading ``[num_layers]``
    axis; split them into ``encoder/layer_{i}``."""
    out = {}
    for key, v in flat.items():
        if "/encoder/layers/" in key:
            for i in range(num_layers):
                out[key.replace("/encoder/layers/",
                                f"/encoder/layer_{i}/")] = np.asarray(v)[i]
        else:
            out[key] = v
    return out


def bevformer_params_to_torch(flat: Mapping[str, np.ndarray], cfg: dict
                              ) -> "OrderedDict[str, torch.Tensor]":
    """Flattened JAX ``BEVFormer`` variables of the model ``cfg`` -> the
    port's state_dict (see ``jax_params_to_torch``)."""
    enc = cfg["pts_bbox_head"]["transformer"]["encoder"]
    if enc.get("scan_layers"):
        flat = unstack_scanned_layers(flat, enc.get("num_layers", 6))
    pm, sm, mha = bevformer_name_map(cfg)
    sd = map_to_state_dict(flat, pm, sm)
    for tname, fpath in mha.items():
        key = "/".join(("params",) + fpath)

        def get(*leaf):
            return np.asarray(flat["/".join((key,) + leaf)], np.float32)

        e = get("out", "kernel").shape[-1]
        sd[f"{tname}.in_proj_weight"] = torch.from_numpy(np.concatenate(
            [get(n, "kernel").reshape(e, -1).T for n in
             ("query", "key", "value")]).copy())
        sd[f"{tname}.in_proj_bias"] = torch.from_numpy(np.concatenate(
            [get(n, "bias").reshape(-1) for n in ("query", "key", "value")]))
        sd[f"{tname}.out_proj.weight"] = torch.from_numpy(
            get("out", "kernel").reshape(-1, e).T.copy())
        sd[f"{tname}.out_proj.bias"] = torch.tensor(get("out", "bias"))
    return sd
