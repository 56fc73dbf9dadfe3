"""Weights carried from the JAX package's parameter tree to the port.

`state_dict_from_jax(params)` maps a flax `UVHandDETR` tree
(`{'params': ...}` of numpy arrays; sine or learned position encoding,
two-stage with box refinement or single-stage, the DINO variant, `use_dn`,
the ResNet-50, Swin or ConvNeXt backbone, or none: a precomputed-feature
model) onto the port's `state_dict`,
whose names are the upstream reference's state-dict names. It is the
inverse of the JAX package's `convert_reference_detr` (and, for the Swin
and the ConvNeXt, of its `convert_swin_checkpoint` and
`convert_convnext_checkpoint`), and names the leaves those lack as the
reference does:

  backbone/*                       -> backbone.0.body.*  (torchvision names)
  backbone/stem_conv, stem_norm    -> backbone.0.downsample_layers.0.{0,1}
  backbone/down{i}_norm, _conv     -> backbone.0.downsample_layers.{i}.{0,1}
  backbone/stage{i}_block{j}/*     -> backbone.0.stages.{i}.{j}.* (ConvNeXt)
  backbone/out_norm{i}             -> backbone.0.norm{i} (Swin, ConvNeXt)
  backbone/patch_embed, patch_norm -> backbone.0.patch_embed.proj, .norm (Swin)
  backbone/stage{i}_block{j}/norm1, attn/{relative_position_bias_table,
      qkv, proj}, norm2, fc1, fc2  -> backbone.0.layers.{i}.blocks.{j}.{norm1,
                                      attn.*, norm2, mlp.fc1, mlp.fc2} (Swin)
  backbone/merge{i}/norm, reduction -> backbone.0.layers.{i}.downsample.* (Swin)
  pos_embed/{row,col}_embed        -> backbone.1.{row,col}_embed.weight (the
                                      learned embedding in the reference
                                      Joiner's slot 1; the JAX converter has
                                      no mapping for it)
  input_proj{i}/conv, /gn          -> input_proj.{i}.0, .1
  transformer/encoder_layer{i}/*   -> transformer.encoder.layers.{i}.*
  transformer/decoder_layer{i}/*   -> transformer.decoder.layers.{i}.*
      (flax query/key/value/out kernels (in, heads, head_dim) joined into
       torch's in_proj_weight / out_proj)
  transformer/pos_trans1/2/3       -> transformer.pos_trans.0/2/4
  transformer/reference_points     -> transformer.reference_points (single stage)
  query_embed                      -> query_embed.weight (single stage)
  transformer/cls_head{i}          -> cls_embed.{i}
  transformer/cls_head_shared      -> cls_embed.{0..n} (one head, registered
                                      once per layer: no box refinement)
  transformer/(obj_)key_head{i}/layer{j} -> (obj_)key_embed.{i}.layers.{j}
  mano_pose_head (one module)      -> mano_pose_embed.{0..n} (likewise beta,
                                      cams, rot, rad: the reference
                                      registers the same module n times)
  label_enc/embedding              -> label_enc.weight (`use_dn`)
  temporal_param_head/ta_<p>/...   -> temporal_param_head.ta_<p>.* (the temporal
                                      head, `temporal_head_from_jax`)
DINO variant (a `tgt_embed` leaf), the reference DINO names:
  transformer/tgt_embed            -> transformer.tgt_embed.weight
  transformer/two_stage_learn_xy   -> transformer.two_stage_wh_embedding.weight
  transformer/ref_point_head/layer{j} -> transformer.decoder.ref_point_head.layers.{j}
  transformer/decoder_norm         -> transformer.decoder.norm
  transformer/cls_head_shared      -> class_embed.{0..n-1} (tied)
  transformer/(obj_)key_head_shared/layer{j} -> (obj_)key_embed.{0..n-1}.layers.{j}
  transformer/enc_out_cls_head     -> transformer.enc_out_class_embed
  transformer/enc_out_(obj_)key_head/layer{j}
                                   -> transformer.enc_out_(obj_)key_embed.layers.{j}

An `AssemblyDETR` tree (`transformer/enc0` present) maps to the
reference's assembly names: `backbone`, `input_proj{i}` as above,
`transformer/enc{i}`, `dec{i}` -> `transformer.encoder.layers.{i}`,
`transformer.decoder.layers.{i}`, `transformer/enc_output(_norm)` ->
`transformer.enc_output(_norm)`, `transformer/query_embed` ->
`query_embed.weight`, `transformer/cls{i}` -> `cls_embed.{i}`,
`transformer/key{i}`, `okey{i}` -> `keypoint_embed.{i}`,
`obj_keypoint_embed.{i}` (`.layers.{j}`; the tree holds the encoder's
object head only).

The temporal head's blocks: `in_proj`, `out_proj`, and either the BiLSTM
(`bilstm/{fwd,bwd}/OptimizedLSTMCell_0`: the input kernels `ii/if/ig/io`
stacked in torch's gate order into `bilstm.lstm.weight_ih_l0{,_reverse}`,
the recurrent `hi/hf/hg/ho` into `weight_hh_l0{,_reverse}` and their
biases into `bias_hh_l0{,_reverse}`; `bias_ih` is zero: the flax cell has
no input bias) or the ViViT blocks (`temporal_pos`; `ln1_{i}`, `ln2_{i}`
-> `ln1.{i}`, `ln2.{i}`; `attn_{i}` query/key/value/out (in, heads,
head_dim) -> `attn.{i}.in_proj_weight` / `out_proj`; `fc1_{i}`, `fc2_{i}`
-> `fc1.{i}`, `fc2.{i}`). `smoother_state_dict_from_jax` maps an
`ArcticSmoother` tree (`<smoother>/{pos,vel,acc}/{encoder, res{i}/Dense_0,
Dense_1, decoder}`, `<smoother>/fusion`) onto the port's names
(`<smoother>.{pos,vel,acc}.{encoder, res.{i}.fc1, fc2, decoder}`).

`load_torch_checkpoint(path)` is the port's side of the JAX package's
`.pth` import (`uvhand_tpu/train/convert.py::load_torch_checkpoint`): a
reference `{'model': state_dict}` file (or a bare state dict) already holds
the port's names, so it returns that state dict as float tensors.
`convert_torchvision_resnet50(sd)` names a torchvision ResNet-50 state dict
as the port's backbone (`backbone.0.body.*`), dropping the classifier and
the BatchNorms' `num_batches_tracked` (the backbone's BatchNorm is frozen).

Dense kernels (in, out) are transposed to torch's (out, in); convs go
HWIO -> OIHW. A bfloat16 leaf (a `bf16_params` tree) is widened to float32
on the way, which is exact, and arrives as a bfloat16 tensor.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_SHARED_HEADS = (
    ("mano_pose_head", "mano_pose_embed"),
    ("mano_beta_head", "mano_beta_embed"),
    ("hand_cam_head", "hand_cam"),
    ("obj_cam_head", "obj_cam"),
    ("obj_rot_head", "obj_rot"),
    ("obj_rad_head", "obj_rad"),
)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a, np.float32))  # torch takes no numpy bfloat16
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t


def _count(tree: dict, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit())


def _linear(sd: dict, dst: str, node) -> None:
    sd[f"{dst}.weight"] = _t(np.asarray(node["kernel"]).T)
    sd[f"{dst}.bias"] = _t(node["bias"])


def _mha(sd: dict, dst: str, node) -> None:
    """flax MultiHeadDotProductAttention (query/key/value kernels (d, heads,
    head_dim), out (heads, head_dim, d)) -> torch's packed in_proj and
    out_proj."""
    d = np.asarray(node["query"]["kernel"]).shape[0]
    sd[f"{dst}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(node[n]["kernel"]).reshape(d, d).T for n in ("query", "key", "value")]))
    sd[f"{dst}.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(node[n]["bias"]).reshape(d) for n in ("query", "key", "value")]))
    sd[f"{dst}.out_proj.weight"] = _t(np.asarray(node["out"]["kernel"]).reshape(d, d).T)
    sd[f"{dst}.out_proj.bias"] = _t(node["out"]["bias"])


def temporal_head_from_jax(head: dict,
                           prefix: str = "temporal_param_head") -> Dict[str, torch.Tensor]:
    """A flax `TemporalParamHead` tree -> the port's `TemporalParamHead`
    state dict, its names under `prefix`."""
    sd: Dict[str, torch.Tensor] = {}
    for name, block in head.items():
        dst = f"{prefix}.{name}"
        _linear(sd, f"{dst}.in_proj", block["in_proj"])
        _linear(sd, f"{dst}.out_proj", block["out_proj"])
        if "bilstm" in block:
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
                cell = block["bilstm"][direction]["OptimizedLSTMCell_0"]
                w_ih = np.concatenate([np.asarray(cell[g]["kernel"]).T
                                       for g in ("ii", "if", "ig", "io")])
                lstm = f"{dst}.bilstm.lstm"
                sd[f"{lstm}.weight_ih_l0{suffix}"] = _t(w_ih)
                sd[f"{lstm}.weight_hh_l0{suffix}"] = _t(np.concatenate(
                    [np.asarray(cell[g]["kernel"]).T for g in ("hi", "hf", "hg", "ho")]))
                sd[f"{lstm}.bias_ih_l0{suffix}"] = _t(np.zeros(w_ih.shape[0], w_ih.dtype))
                sd[f"{lstm}.bias_hh_l0{suffix}"] = _t(np.concatenate(
                    [np.asarray(cell[g]["bias"]) for g in ("hi", "hf", "hg", "ho")]))
            continue
        sd[f"{dst}.temporal_pos"] = _t(block["temporal_pos"])
        for i in range(_count(block, "attn_")):
            _mha(sd, f"{dst}.attn.{i}", block[f"attn_{i}"])
            for n in ("ln1", "ln2"):
                sd[f"{dst}.{n}.{i}.weight"] = _t(block[f"{n}_{i}"]["scale"])
                sd[f"{dst}.{n}.{i}.bias"] = _t(block[f"{n}_{i}"]["bias"])
            for n in ("fc1", "fc2"):
                _linear(sd, f"{dst}.{n}.{i}", block[f"{n}_{i}"])
    return sd


def smoother_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """A flax `ArcticSmoother` tree (`{'params': ...}` or its inner dict) ->
    the port's `ArcticSmoother` state dict."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for name, motion in p.items():
        for branch in ("pos", "vel", "acc"):
            src, dst = motion[branch], f"{name}.{branch}"
            _linear(sd, f"{dst}.encoder", src["encoder"])
            _linear(sd, f"{dst}.decoder", src["decoder"])
            for i in range(_count(src, "res")):
                _linear(sd, f"{dst}.res.{i}.fc1", src[f"res{i}"]["Dense_0"])
                _linear(sd, f"{dst}.res.{i}.fc2", src[f"res{i}"]["Dense_1"])
        _linear(sd, f"{name}.fusion", motion["fusion"])
    return sd


def state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Flax `{'params': ...}` tree (or its inner dict) -> port state_dict."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    def linear(dst, node):
        _linear(sd, dst, node)

    def norm(dst, node):
        sd[f"{dst}.weight"] = _t(node["scale"])
        sd[f"{dst}.bias"] = _t(node["bias"])

    def conv(dst, node):
        sd[f"{dst}.weight"] = _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            sd[f"{dst}.bias"] = _t(node["bias"])

    def frozen_bn(dst, node):
        sd[f"{dst}.weight"] = _t(node["scale"])
        sd[f"{dst}.bias"] = _t(node["bias"])
        sd[f"{dst}.running_mean"] = _t(node["mean"])
        sd[f"{dst}.running_var"] = _t(node["var"])

    def resnet(bb, body="backbone.0.body"):
        conv(f"{body}.conv1", bb["conv1"])
        frozen_bn(f"{body}.bn1", bb["bn1"])
        for name in sorted(k for k in bb if k.startswith("layer")):
            li, bi = name[len("layer"):].split("_")
            dst = f"{body}.layer{li}.{bi}"
            for ci in (1, 2, 3):
                conv(f"{dst}.conv{ci}", bb[name][f"conv{ci}"])
                frozen_bn(f"{dst}.bn{ci}", bb[name][f"bn{ci}"])
            if "down_conv" in bb[name]:
                conv(f"{dst}.downsample.0", bb[name]["down_conv"])
                frozen_bn(f"{dst}.downsample.1", bb[name]["down_bn"])

    def convnext(bb, body="backbone.0"):
        conv(f"{body}.downsample_layers.0.0", bb["stem_conv"])
        norm(f"{body}.downsample_layers.0.1", bb["stem_norm"])
        for name in (k for k in bb if k.startswith("down") and k.endswith("_norm")):
            i = name[len("down"):-len("_norm")]
            norm(f"{body}.downsample_layers.{i}.0", bb[f"down{i}_norm"])
            conv(f"{body}.downsample_layers.{i}.1", bb[f"down{i}_conv"])
        for name in (k for k in bb if k.startswith("stage")):
            i, j = name[len("stage"):].split("_block")
            src, dst = bb[name], f"{body}.stages.{i}.{j}"
            conv(f"{dst}.dwconv", src["dwconv"])
            norm(f"{dst}.norm", src["norm"])
            linear(f"{dst}.pwconv1", src["pwconv1"])
            linear(f"{dst}.pwconv2", src["pwconv2"])
            sd[f"{dst}.gamma"] = _t(src["gamma"])
        for name in (k for k in bb if k.startswith("out_norm")):
            norm(f"{body}.norm{name[len('out_norm'):]}", bb[name])

    def swin(bb, body="backbone.0"):
        conv(f"{body}.patch_embed.proj", bb["patch_embed"])
        norm(f"{body}.patch_embed.norm", bb["patch_norm"])
        for name in (k for k in bb if k.startswith("stage")):
            i, j = name[len("stage"):].split("_block")
            src, dst = bb[name], f"{body}.layers.{i}.blocks.{j}"
            for n in ("norm1", "norm2"):
                norm(f"{dst}.{n}", src[n])
            sd[f"{dst}.attn.relative_position_bias_table"] = _t(
                src["attn"]["relative_position_bias_table"])
            linear(f"{dst}.attn.qkv", src["attn"]["qkv"])
            linear(f"{dst}.attn.proj", src["attn"]["proj"])
            linear(f"{dst}.mlp.fc1", src["fc1"])
            linear(f"{dst}.mlp.fc2", src["fc2"])
        for name in (k for k in bb if k.startswith("merge")):
            dst = f"{body}.layers.{name[len('merge'):]}.downsample"
            norm(f"{dst}.norm", bb[name]["norm"])
            sd[f"{dst}.reduction.weight"] = _t(np.asarray(bb[name]["reduction"]["kernel"]).T)
        for name in (k for k in bb if k.startswith("out_norm")):
            norm(f"{body}.norm{name[len('out_norm'):]}", bb[name])

    bb = p.get("backbone")  # none in a precomputed-feature model
    if bb is None:
        pass
    elif "stem_conv" in bb:  # the ConvNeXt in the Joiner's slot 0
        convnext(bb)
    elif "patch_embed" in bb:  # the Swin in the Joiner's slot 0
        swin(bb)
    else:  # torchvision ResNet-50 under the Joiner's slot 0
        resnet(bb)
    if "label_enc" in p:
        sd["label_enc.weight"] = _t(p["label_enc"]["embedding"])
    if "pos_embed" in p:
        for name in ("row_embed", "col_embed"):
            sd[f"backbone.1.{name}.weight"] = _t(p["pos_embed"][name])
    if "query_embed" in p:
        sd["query_embed.weight"] = _t(p["query_embed"])

    for i in range(_count(p, "input_proj")):
        conv(f"input_proj.{i}.0", p[f"input_proj{i}"]["conv"])
        norm(f"input_proj.{i}.1", p[f"input_proj{i}"]["gn"])

    t = p["transformer"]
    sd["transformer.level_embed"] = _t(t["level_embed"])
    msda = ("sampling_offsets", "attention_weights", "value_proj", "output_proj")

    def encoder_layer(dst, src):
        for lin in msda:
            linear(f"{dst}.self_attn.{lin}", src["self_attn"][lin])
        for n in ("norm1", "norm2"):
            norm(f"{dst}.{n}", src[n])
        for lin in ("linear1", "linear2"):
            linear(f"{dst}.{lin}", src[lin])

    def decoder_layer(dst, src):
        for lin in msda:
            linear(f"{dst}.cross_attn.{lin}", src["cross_attn"][lin])
        _mha(sd, f"{dst}.self_attn", src["self_attn"])
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{dst}.{n}", src[n])
        for lin in ("linear1", "linear2"):
            linear(f"{dst}.{lin}", src[lin])

    if "enc0" in t:  # the AssemblyHands model
        for i in range(_count(t, "enc")):
            encoder_layer(f"transformer.encoder.layers.{i}", t[f"enc{i}"])
        for i in range(_count(t, "dec")):
            decoder_layer(f"transformer.decoder.layers.{i}", t[f"dec{i}"])
        linear("transformer.enc_output", t["enc_output"])
        norm("transformer.enc_output_norm", t["enc_output_norm"])
        sd["query_embed.weight"] = _t(t["query_embed"])
        for i in range(_count(t, "cls")):
            linear(f"cls_embed.{i}", t[f"cls{i}"])
        # (the object heads of the decoder layers are never called: the
        # JAX tree holds the encoder's, okey{n_dec}, alone)
        for src, dst in (("key", "keypoint_embed"), ("okey", "obj_keypoint_embed")):
            for name in (k for k in t if k.startswith(src) and k[len(src):].isdigit()):
                for j in range(3):
                    linear(f"{dst}.{name[len(src):]}.layers.{j}", t[name][f"layer{j}"])
        return sd

    for i in range(_count(t, "encoder_layer")):
        encoder_layer(f"transformer.encoder.layers.{i}", t[f"encoder_layer{i}"])
    n_dec = _count(t, "decoder_layer")
    for i in range(n_dec):
        decoder_layer(f"transformer.decoder.layers.{i}", t[f"decoder_layer{i}"])

    two_stage = "enc_output" in t
    dino = "tgt_embed" in t
    if two_stage:
        linear("transformer.enc_output", t["enc_output"])
        norm("transformer.enc_output_norm", t["enc_output_norm"])
    if dino:
        tr = "transformer"
        sd[f"{tr}.tgt_embed.weight"] = _t(t["tgt_embed"])
        sd[f"{tr}.two_stage_wh_embedding.weight"] = _t(
            np.asarray(t["two_stage_learn_xy"]).reshape(1, -1))
        for j in range(2):
            linear(f"{tr}.decoder.ref_point_head.layers.{j}", t["ref_point_head"][f"layer{j}"])
        norm(f"{tr}.decoder.norm", t["decoder_norm"])
        linear(f"{tr}.enc_out_class_embed", t["enc_out_cls_head"])
        for src, dst in (("enc_out_key_head", "enc_out_key_embed"),
                         ("enc_out_obj_key_head", "enc_out_obj_key_embed")):
            for j in range(3):
                linear(f"{tr}.{dst}.layers.{j}", t[src][f"layer{j}"])
    elif two_stage:
        for j, name in ((0, "pos_trans1"), (2, "pos_trans2"), (4, "pos_trans3")):
            linear(f"transformer.pos_trans.{j}", t[name])
        norm("transformer.pos_trans_norm", t["pos_trans_norm"])
        sd["transformer.two_stage_learn_xy.weight"] = _t(
            np.asarray(t["two_stage_learn_xy"]).reshape(1, -1))
    else:
        linear("transformer.reference_points", t["reference_points"])

    # two-stage: the extra head is the encoder's (the DINO variant's are the
    # transformer's own); DINO's decoder heads are tied
    num_pred = n_dec + 1 if two_stage and not dino else n_dec
    for i in range(num_pred):
        if dino:
            linear(f"class_embed.{i}", t["cls_head_shared"])
        else:
            linear(f"cls_embed.{i}", t.get(f"cls_head{i}", t.get("cls_head_shared")))
        for src, dst in (("key_head", "key_embed"), ("obj_key_head", "obj_key_embed")):
            src = f"{src}_shared" if dino else f"{src}{i}"
            if src in t:
                for j in range(3):
                    linear(f"{dst}.{i}.layers.{j}", t[src][f"layer{j}"])
    for flax_name, torch_name in _SHARED_HEADS:
        for i in range(num_pred):
            linear(f"{torch_name}.{i}", p[flax_name])
    if "temporal_param_head" in p:
        sd.update(temporal_head_from_jax(p["temporal_param_head"]))
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict from a reference `.pth` training checkpoint
    (`{'model': state_dict, ...}`, the reference's main.py layout, or a
    bare state dict): its names are the port's, so no name is changed."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict) \
        else ckpt
    return {k: v.detach().cpu() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def convert_torchvision_resnet50(state_dict) -> Dict[str, torch.Tensor]:
    """A torchvision resnet50 state dict (tensors or numpy arrays) -> the
    port's backbone names (`backbone.0.body.conv1.weight`, ...): the
    classifier (`fc.*`) and the BatchNorms' `num_batches_tracked` dropped,
    every tensor float32 on the CPU."""
    return {f"backbone.0.body.{k}": torch.as_tensor(np.asarray(
                v.detach().cpu() if isinstance(v, torch.Tensor) else v), dtype=torch.float32)
            for k, v in state_dict.items()
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
