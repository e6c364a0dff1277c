"""Upstream checkpoint → flax-layout tree conversion for the port, the
counterpart of ``videotuna_tpu/tools/convert_weights.py``, whose maps it
keeps as they are: its output is the nested dict of numpy arrays in the
JAX package's parameter layout, and ``tools/from_jax.py`` copies that tree
into the port's modules strictly, so the layout has one source.  Plain
numpy, and torch only to read pickled checkpoints.

Pieces:
- ``load_torch_state_dict``: .pt/.pth/.ckpt (Lightning ``state_dict`` key)
  through ``torch.load``, .safetensors through ``read_safetensors`` (a
  small reader of the format: an 8-byte header length, a JSON header,
  little-endian buffers); prefix stripping (module./model./
  model.diffusion_model.); ``split_lightning_components`` for monolithic
  VideoCrafter-style checkpoints.
- layout transforms: torch Linear (out,in) → flax kernel (in,out); torch
  Conv (out,in,*k) → flax (*k,in,out); qkv-fused splits; DenseGeneral
  head reshapes; ``inflate_conv2d_to_3d``.
- ``ConversionMap``: ordered (regex → flax path template + transform)
  rules; ``verify_tree_shapes`` (mismatches are reported, never skipped)
  and ``merge_into_tree``.
- the maps of the families the port runs: ``stdit_map``, ``stdit8_map``,
  ``wan_map``, ``hunyuan_map``, ``cogvideox_map``, ``wan_vae_map``,
  ``hunyuan_vae_map``, ``cogvideox_vae_map``, ``t5_map``,
  ``clip_text_map``, ``llama_map``, ``lvdm_map``, ``stepllm_map``,
  ``stepvideo_map`` (after ``preprocess_split_headwise``), ``mochi_map``
  (the Mochi VAE's is ``models/mochi_vae.py:mochi_vae_map``).  The maps of the
  families the port does not run yet raise ``NotImplementedError`` naming
  their ROADMAP.md item.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Transform = Callable[[np.ndarray], np.ndarray]

STRIP_PREFIXES = ("module.", "model.diffusion_model.", "model.")


def load_torch_state_dict(path: str,
                          strip: Sequence[str] = STRIP_PREFIXES
                          ) -> Dict[str, np.ndarray]:
    """Load any torch-family checkpoint into {name: np.ndarray}."""
    if str(path).endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        import torch
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        sd = {k: _to_numpy(v) for k, v in obj.items() if hasattr(v, "shape")}
    return strip_prefixes(sd, strip)


def _to_numpy(v) -> np.ndarray:
    if not hasattr(v, "detach"):
        return np.asarray(v)
    v = v.detach().cpu()
    if str(v.dtype) == "torch.bfloat16":   # numpy has no bfloat16
        v = v.float()
    return v.numpy()


_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a ``.safetensors`` file: an 8-byte little-endian
    header length n, n bytes of JSON ({name: {"dtype", "shape",
    "data_offsets": [begin, end]}}, offsets into the buffer after the
    header; ``__metadata__`` skipped), then the little-endian buffers.
    BF16 tensors come back as float32 (their 16 bits as the high half)."""
    import json
    import struct
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        buf = data[begin:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(buf, _SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             "which this reader does not take")
        out[name] = arr.reshape(shape).copy()
    return out


def strip_prefixes(sd: Dict[str, np.ndarray],
                   prefixes: Sequence[str] = STRIP_PREFIXES
                   ) -> Dict[str, np.ndarray]:
    """Strip the longest matching prefix shared by ALL keys (DeepSpeed's
    ``module.``, Lightning's ``model.``)."""
    out = dict(sd)
    changed = True
    while changed:
        changed = False
        for p in prefixes:
            if out and all(k.startswith(p) for k in out):
                out = {k[len(p):]: v for k, v in out.items()}
                changed = True
    return out


LIGHTNING_COMPONENT_PREFIXES = {
    "denoiser": ("model.diffusion_model.", "denoiser."),
    "first_stage": ("first_stage_model.", "first_stage."),
    "cond_stage": ("cond_stage_model.", "cond_stage."),
    "cond_stage_2": ("img_cond_stage_model.", "cond_stage_2."),
}


def split_lightning_components(sd: Dict[str, np.ndarray]
                               ) -> Dict[str, Dict[str, np.ndarray]]:
    """Split a MONOLITHIC Lightning checkpoint (VideoCrafter-style
    ``model.ckpt`` holding denoiser + VAE + text encoder in one state
    dict) into per-component sub-dicts with prefixes stripped — the
    reference ships a dedicated script for this
    (tools/videocrafter_checkpoint_converter.py:1-50). Keys matching no
    known component land under ``"other"``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in sd.items():
        for comp, prefixes in LIGHTNING_COMPONENT_PREFIXES.items():
            hit = next((p for p in prefixes if key.startswith(p)), None)
            if hit is not None:
                out.setdefault(comp, {})[key[len(hit):]] = val
                break
        else:
            out.setdefault("other", {})[key] = val
    return out


# ---------------------------------------------------------------------------
# Layout transforms
# ---------------------------------------------------------------------------

def t_linear(w: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) → flax Dense kernel (in, out)."""
    return np.ascontiguousarray(w.T)


def t_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv (out, in, *k) → flax (*k, in, out)."""
    nd = w.ndim
    perm = tuple(range(2, nd)) + (1, 0)
    return np.ascontiguousarray(w.transpose(perm))


def t_cfirst_patch_rows(patch: Tuple[int, int, int],
                        out_ch: int) -> Transform:
    """Final-layer rows ordered (C, pt, ph, pw) in torch (hyvideo
    unpatchify models.py:807-819 einsum nthwcopq) → our (pt, ph, pw, C)
    row order, then the usual Linear transpose. Works for .weight (2D)
    and .bias (1D)."""
    pt, ph, pw = patch

    def f(w: np.ndarray) -> np.ndarray:
        if w.ndim == 1:
            return np.ascontiguousarray(
                w.reshape(out_ch, pt, ph, pw).transpose(1, 2, 3, 0)
                .reshape(-1))
        out_dim, hid = w.shape
        wr = w.reshape(out_ch, pt, ph, pw, hid).transpose(1, 2, 3, 0, 4)
        return t_linear(wr.reshape(out_dim, hid))
    return f


def t_dense_general(heads: int) -> Transform:
    """torch (H·hd, in) → flax DenseGeneral kernel (in, H, hd)."""
    def f(w: np.ndarray) -> np.ndarray:
        out_dim, in_dim = w.shape
        hd = out_dim // heads
        return np.ascontiguousarray(
            w.reshape(heads, hd, in_dim).transpose(2, 0, 1))
    return f


def t_dense_general_bias(heads: int) -> Transform:
    def f(b: np.ndarray) -> np.ndarray:
        return b.reshape(heads, -1)
    return f


def split_qkv(w: np.ndarray, n: int = 3) -> List[np.ndarray]:
    """Fused qkv (3·d, in) → [q, k, v] each (d, in)."""
    return list(np.split(w, n, axis=0))


def preprocess_split_fused(sd: Dict[str, np.ndarray],
                           pattern: str,
                           token: str,
                           names: Sequence[str]
                           ) -> Dict[str, np.ndarray]:
    """Rewrite fused projections into separate entries BEFORE rule mapping:
    any key matching ``pattern`` (and containing ``token``) is split along
    dim 0 into len(names) parts, each re-keyed with ``token`` → name.
    Applies to both .weight and .bias."""
    rx = re.compile(pattern)
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if rx.search(key) and token in key:
            parts = np.split(val, len(names), axis=0)
            for name, part in zip(names, parts):
                out[key.replace(token, name)] = part
        else:
            out[key] = val
    return out


def preprocess_split_fused_qkv(sd: Dict[str, np.ndarray],
                               pattern: str,
                               names: Sequence[str] = ("q", "k", "v")
                               ) -> Dict[str, np.ndarray]:
    """Fused-qkv specialization of :func:`preprocess_split_fused`."""
    return preprocess_split_fused(sd, pattern, "qkv", names)


def inflate_conv2d_to_3d(w2d: np.ndarray, kt: int = 3,
                         center: bool = True) -> np.ndarray:
    """SD 2D→3D kernel inflation (reference load_weights.py:69-157):
    flax layout (kh, kw, in, out) → (kt, kh, kw, in, out) with the 2D kernel
    at the temporal center (identity over time at init)."""
    w3d = np.zeros((kt,) + w2d.shape, w2d.dtype)
    idx = kt // 2 if center else kt - 1
    w3d[idx] = w2d
    return w3d


# ---------------------------------------------------------------------------
# Conversion engine
# ---------------------------------------------------------------------------

class ConversionMap:
    """Ordered regex rules mapping torch names → flax tree paths.

    rule = (pattern, path_template, transform | None). The template may use
    backrefs (``\\1``); transform defaults to t_linear for ``.weight`` of 2D
    tensors and identity otherwise.
    """

    def __init__(self, rules: Sequence[Tuple[str, str,
                                             Optional[Transform]]]):
        self.rules = [(re.compile(p), t, fn) for p, t, fn in rules]

    def convert(self, sd: Dict[str, np.ndarray],
                strict: bool = False) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        unmatched: List[str] = []
        for name, val in sd.items():
            for pat, template, fn in self.rules:
                m = pat.match(name)
                if not m:
                    continue
                path = m.expand(template)
                if fn is None and name.endswith(".weight") and val.ndim == 2:
                    val = t_linear(val)
                elif fn is not None:
                    val = fn(val)
                node = tree
                parts = path.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = val
                break
            else:
                unmatched.append(name)
        if strict and unmatched:
            raise KeyError(f"Unconverted torch params: {unmatched[:20]}"
                           f"{'…' if len(unmatched) > 20 else ''}")
        return tree


def verify_tree_shapes(converted: Any, target: Any,
                       path: str = "") -> List[str]:
    """Return a list of mismatch descriptions (empty = exact match)."""
    problems: List[str] = []
    if isinstance(target, dict):
        conv = converted if isinstance(converted, dict) else {}
        for k, v in target.items():
            if k not in conv:
                problems.append(f"missing {path}/{k}")
            else:
                problems += verify_tree_shapes(conv[k], v, f"{path}/{k}")
        for k in conv:
            if k not in target:
                problems.append(f"extra {path}/{k}")
    else:
        if tuple(np.shape(converted)) != tuple(np.shape(target)):
            problems.append(
                f"shape {path}: {np.shape(converted)} vs "
                f"{np.shape(target)}")
    return problems


def merge_into_tree(target: Dict[str, Any],
                    converted: Dict[str, Any]) -> Dict[str, Any]:
    """Partial load: converted leaves override target where shapes match
    (the reference's partial-load path, train_utils.py:198-215 — but
    mismatches raise instead of silently skipping)."""
    out = dict(target)
    for k, v in converted.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_into_tree(out[k], v)
        elif k in out:
            if tuple(np.shape(out[k])) != tuple(np.shape(v)):
                raise ValueError(
                    f"shape mismatch for {k}: {np.shape(v)} vs "
                    f"{np.shape(out[k])}")
            out[k] = v
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Family maps (worked example: STDiT — the PR1 model)
# ---------------------------------------------------------------------------

def stdit_map(heads: int = 16) -> ConversionMap:
    """Open-Sora v1.0 STDiT torch names → videotuna_tpu STDiT tree."""
    dg = t_dense_general(heads)
    dgb = t_dense_general_bias(heads)
    return ConversionMap([
        (r"x_embedder\.proj\.weight", r"x_embedder/proj/kernel", t_conv),
        (r"x_embedder\.proj\.bias", r"x_embedder/proj/bias", None),
        (r"t_embedder\.mlp\.0\.weight", r"t_embedder/fc1/kernel", t_linear),
        (r"t_embedder\.mlp\.0\.bias", r"t_embedder/fc1/bias", None),
        (r"t_embedder\.mlp\.2\.weight", r"t_embedder/fc2/kernel", t_linear),
        (r"t_embedder\.mlp\.2\.bias", r"t_embedder/fc2/bias", None),
        (r"t_block\.1\.weight", r"t_block/kernel", t_linear),
        (r"t_block\.1\.bias", r"t_block/bias", None),
        (r"y_embedder\.y_proj\.fc1\.weight", r"y_proj1/kernel", t_linear),
        (r"y_embedder\.y_proj\.fc1\.bias", r"y_proj1/bias", None),
        (r"y_embedder\.y_proj\.fc2\.weight", r"y_proj2/kernel", t_linear),
        (r"y_embedder\.y_proj\.fc2\.bias", r"y_proj2/bias", None),
        (r"blocks\.(\d+)\.scale_shift_table",
         r"block_\1/scale_shift_table", None),
        # spatial attention (torch fused qkv handled by caller splitting)
        (r"blocks\.(\d+)\.attn\.q\.weight", r"block_\1/attn/q/kernel", dg),
        (r"blocks\.(\d+)\.attn\.q\.bias", r"block_\1/attn/q/bias", dgb),
        (r"blocks\.(\d+)\.attn\.k\.weight", r"block_\1/attn/k/kernel", dg),
        (r"blocks\.(\d+)\.attn\.k\.bias", r"block_\1/attn/k/bias", dgb),
        (r"blocks\.(\d+)\.attn\.v\.weight", r"block_\1/attn/v/kernel", dg),
        (r"blocks\.(\d+)\.attn\.v\.bias", r"block_\1/attn/v/bias", dgb),
        (r"blocks\.(\d+)\.attn\.proj\.weight",
         r"block_\1/attn/out/kernel", t_linear),
        (r"blocks\.(\d+)\.attn\.proj\.bias",
         r"block_\1/attn/out/bias", None),
        # temporal attention
        (r"blocks\.(\d+)\.attn_temp\.q\.weight",
         r"block_\1/attn_temp/q/kernel", dg),
        (r"blocks\.(\d+)\.attn_temp\.q\.bias",
         r"block_\1/attn_temp/q/bias", dgb),
        (r"blocks\.(\d+)\.attn_temp\.k\.weight",
         r"block_\1/attn_temp/k/kernel", dg),
        (r"blocks\.(\d+)\.attn_temp\.k\.bias",
         r"block_\1/attn_temp/k/bias", dgb),
        (r"blocks\.(\d+)\.attn_temp\.v\.weight",
         r"block_\1/attn_temp/v/kernel", dg),
        (r"blocks\.(\d+)\.attn_temp\.v\.bias",
         r"block_\1/attn_temp/v/bias", dgb),
        (r"blocks\.(\d+)\.attn_temp\.proj\.weight",
         r"block_\1/attn_temp/out/kernel", t_linear),
        (r"blocks\.(\d+)\.attn_temp\.proj\.bias",
         r"block_\1/attn_temp/out/bias", None),
        # cross attention
        (r"blocks\.(\d+)\.cross_attn\.q_linear\.weight",
         r"block_\1/cross_attn/q/kernel", dg),
        (r"blocks\.(\d+)\.cross_attn\.q_linear\.bias",
         r"block_\1/cross_attn/q/bias", dgb),
        (r"blocks\.(\d+)\.cross_attn\.proj\.weight",
         r"block_\1/cross_attn/out/kernel", t_linear),
        (r"blocks\.(\d+)\.cross_attn\.proj\.bias",
         r"block_\1/cross_attn/out/bias", None),
        # fused kv_linear pre-split via preprocess_split_fused(sd,
        # r"cross_attn\.kv_linear", "kv_linear", ("k_linear", "v_linear"))
        (r"blocks\.(\d+)\.cross_attn\.k_linear\.weight",
         r"block_\1/cross_attn/k/kernel", dg),
        (r"blocks\.(\d+)\.cross_attn\.k_linear\.bias",
         r"block_\1/cross_attn/k/bias", dgb),
        (r"blocks\.(\d+)\.cross_attn\.v_linear\.weight",
         r"block_\1/cross_attn/v/kernel", dg),
        (r"blocks\.(\d+)\.cross_attn\.v_linear\.bias",
         r"block_\1/cross_attn/v/bias", dgb),
        # mlp
        (r"blocks\.(\d+)\.mlp\.fc1\.weight",
         r"block_\1/mlp/fc1/kernel", t_linear),
        (r"blocks\.(\d+)\.mlp\.fc1\.bias", r"block_\1/mlp/fc1/bias", None),
        (r"blocks\.(\d+)\.mlp\.fc2\.weight",
         r"block_\1/mlp/fc2/kernel", t_linear),
        (r"blocks\.(\d+)\.mlp\.fc2\.bias", r"block_\1/mlp/fc2/bias", None),
        # final
        (r"final_layer\.scale_shift_table",
         r"final_scale_shift_table", None),
        (r"final_layer\.linear\.weight", r"final_linear/kernel", t_linear),
        (r"final_layer\.linear\.bias", r"final_linear/bias", None),
    ])


def stdit8_map(heads: int = 16) -> ConversionMap:
    """Open-Sora 1.2 / stdit8 paired-block layout (stdit8.py:285-318:
    spatial_blocks.N + temporal_blocks.N, qk-norm attention, fused qkv
    pre-split by the caller) → videotuna_tpu STDiT(paired_blocks=True)
    pair_N/spatial|temporal trees."""
    dg = t_dense_general(heads)
    dgb = t_dense_general_bias(heads)
    rules: List[Tuple[str, str, Optional[Transform]]] = [
        (r"x_embedder\.proj\.weight", r"x_embedder/proj/kernel", t_conv),
        (r"x_embedder\.proj\.bias", r"x_embedder/proj/bias", None),
        (r"t_embedder\.mlp\.0\.weight", r"t_embedder/fc1/kernel",
         t_linear),
        (r"t_embedder\.mlp\.0\.bias", r"t_embedder/fc1/bias", None),
        (r"t_embedder\.mlp\.2\.weight", r"t_embedder/fc2/kernel",
         t_linear),
        (r"t_embedder\.mlp\.2\.bias", r"t_embedder/fc2/bias", None),
        (r"t_block\.1\.weight", r"t_block/kernel", t_linear),
        (r"t_block\.1\.bias", r"t_block/bias", None),
        (r"fps_embedder\.mlp\.0\.weight", r"fps_embedder/fc1/kernel",
         t_linear),
        (r"fps_embedder\.mlp\.0\.bias", r"fps_embedder/fc1/bias", None),
        (r"fps_embedder\.mlp\.2\.weight", r"fps_embedder/fc2/kernel",
         t_linear),
        (r"fps_embedder\.mlp\.2\.bias", r"fps_embedder/fc2/bias", None),
        (r"y_embedder\.y_proj\.fc1\.weight", r"y_proj1/kernel",
         t_linear),
        (r"y_embedder\.y_proj\.fc1\.bias", r"y_proj1/bias", None),
        (r"y_embedder\.y_proj\.fc2\.weight", r"y_proj2/kernel",
         t_linear),
        (r"y_embedder\.y_proj\.fc2\.bias", r"y_proj2/bias", None),
        (r"final_layer\.scale_shift_table",
         r"final_scale_shift_table", None),
        (r"final_layer\.linear\.weight", r"final_linear/kernel",
         t_linear),
        (r"final_layer\.linear\.bias", r"final_linear/bias", None),
    ]
    for src_root, sub in (("spatial_blocks", "spatial"),
                          ("temporal_blocks", "temporal")):
        pre = rf"{src_root}\.(\d+)"
        out = rf"pair_\1/{sub}"
        rules += [
            (pre + r"\.scale_shift_table", out + r"/scale_shift_table",
             None),
            (pre + r"\.attn\.q\.weight", out + r"/attn/q/kernel", dg),
            (pre + r"\.attn\.q\.bias", out + r"/attn/q/bias", dgb),
            (pre + r"\.attn\.k\.weight", out + r"/attn/k/kernel", dg),
            (pre + r"\.attn\.k\.bias", out + r"/attn/k/bias", dgb),
            (pre + r"\.attn\.v\.weight", out + r"/attn/v/kernel", dg),
            (pre + r"\.attn\.v\.bias", out + r"/attn/v/bias", dgb),
            (pre + r"\.attn\.q_norm\.weight",
             out + r"/attn/q_norm/scale", None),
            (pre + r"\.attn\.k_norm\.weight",
             out + r"/attn/k_norm/scale", None),
            (pre + r"\.attn\.proj\.weight", out + r"/attn/out/kernel",
             t_linear),
            (pre + r"\.attn\.proj\.bias", out + r"/attn/out/bias",
             None),
            (pre + r"\.cross_attn\.q_linear\.weight",
             out + r"/cross_attn/q/kernel", dg),
            (pre + r"\.cross_attn\.q_linear\.bias",
             out + r"/cross_attn/q/bias", dgb),
            (pre + r"\.cross_attn\.k_linear\.weight",
             out + r"/cross_attn/k/kernel", dg),
            (pre + r"\.cross_attn\.k_linear\.bias",
             out + r"/cross_attn/k/bias", dgb),
            (pre + r"\.cross_attn\.v_linear\.weight",
             out + r"/cross_attn/v/kernel", dg),
            (pre + r"\.cross_attn\.v_linear\.bias",
             out + r"/cross_attn/v/bias", dgb),
            (pre + r"\.cross_attn\.proj\.weight",
             out + r"/cross_attn/out/kernel", t_linear),
            (pre + r"\.cross_attn\.proj\.bias",
             out + r"/cross_attn/out/bias", None),
            (pre + r"\.mlp\.fc1\.weight", out + r"/mlp/fc1/kernel",
             t_linear),
            (pre + r"\.mlp\.fc1\.bias", out + r"/mlp/fc1/bias", None),
            (pre + r"\.mlp\.fc2\.weight", out + r"/mlp/fc2/kernel",
             t_linear),
            (pre + r"\.mlp\.fc2\.bias", out + r"/mlp/fc2/bias", None),
        ]
    return ConversionMap(rules)


def wan_map(heads: int = 12) -> ConversionMap:
    """Wan 2.1 torch names (models/wan/wan/modules/model.py) →
    videotuna_tpu WanModel tree."""
    rules: List[Tuple[str, str, Optional[Transform]]] = [
        (r"patch_embedding\.weight", r"patch_embedding/kernel", t_conv),
        (r"patch_embedding\.bias", r"patch_embedding/bias", None),
        (r"text_embedding\.0\.weight", r"text_fc1/kernel", t_linear),
        (r"text_embedding\.0\.bias", r"text_fc1/bias", None),
        (r"text_embedding\.2\.weight", r"text_fc2/kernel", t_linear),
        (r"text_embedding\.2\.bias", r"text_fc2/bias", None),
        (r"time_embedding\.0\.weight", r"time_fc1/kernel", t_linear),
        (r"time_embedding\.0\.bias", r"time_fc1/bias", None),
        (r"time_embedding\.2\.weight", r"time_fc2/kernel", t_linear),
        (r"time_embedding\.2\.bias", r"time_fc2/bias", None),
        (r"time_projection\.1\.weight", r"time_projection/kernel",
         t_linear),
        (r"time_projection\.1\.bias", r"time_projection/bias", None),
        (r"head\.head\.weight", r"head_out/kernel", t_linear),
        (r"head\.head\.bias", r"head_out/bias", None),
        (r"head\.modulation", r"head_modulation",
         lambda w: w.reshape(2, -1)),
        (r"blocks\.(\d+)\.modulation", r"block_\1/modulation",
         lambda w: w.reshape(6, -1)),
        (r"blocks\.(\d+)\.norm3\.weight", r"block_\1/norm3/scale", None),
        (r"blocks\.(\d+)\.norm3\.bias", r"block_\1/norm3/bias", None),
    ]
    for torch_attn, ours in (("self_attn", "self"), ("cross_attn", "cross")):
        for p in "qkv":
            # q/k/v are full-dim Dense (the qk norm runs before head split)
            rules += [
                (rf"blocks\.(\d+)\.{torch_attn}\.{p}\.weight",
                 rf"block_\1/{ours}_{p}/kernel", t_linear),
                (rf"blocks\.(\d+)\.{torch_attn}\.{p}\.bias",
                 rf"block_\1/{ours}_{p}/bias", None),
            ]
        rules += [
            (rf"blocks\.(\d+)\.{torch_attn}\.o\.weight",
             rf"block_\1/{ours}_out/kernel", t_linear),
            (rf"blocks\.(\d+)\.{torch_attn}\.o\.bias",
             rf"block_\1/{ours}_out/bias", None),
            (rf"blocks\.(\d+)\.{torch_attn}\.norm_q\.weight",
             rf"block_\1/{ours}_q_norm/scale", None),
            (rf"blocks\.(\d+)\.{torch_attn}\.norm_k\.weight",
             rf"block_\1/{ours}_k_norm/scale", None),
        ]
    # i2v image cross attention
    rules += [
        (r"blocks\.(\d+)\.cross_attn\.k_img\.weight",
         r"block_\1/cross_k_img/kernel", t_linear),
        (r"blocks\.(\d+)\.cross_attn\.k_img\.bias",
         r"block_\1/cross_k_img/bias", None),
        (r"blocks\.(\d+)\.cross_attn\.v_img\.weight",
         r"block_\1/cross_v_img/kernel", t_linear),
        (r"blocks\.(\d+)\.cross_attn\.v_img\.bias",
         r"block_\1/cross_v_img/bias", None),
        (r"blocks\.(\d+)\.cross_attn\.norm_k_img\.weight",
         r"block_\1/cross_k_img_norm/scale", None),
        (r"blocks\.(\d+)\.ffn\.0\.weight", r"block_\1/ffn1/kernel",
         t_linear),
        (r"blocks\.(\d+)\.ffn\.0\.bias", r"block_\1/ffn1/bias", None),
        (r"blocks\.(\d+)\.ffn\.2\.weight", r"block_\1/ffn2/kernel",
         t_linear),
        (r"blocks\.(\d+)\.ffn\.2\.bias", r"block_\1/ffn2/bias", None),
    ]
    return ConversionMap(rules)


def hunyuan_map(heads: int = 24,
                patch: Tuple[int, int, int] = (1, 2, 2),
                out_ch: int = 16) -> ConversionMap:
    """HunyuanVideo torch names (hyvideo modules/models.py) →
    videotuna_tpu HYVideoDiT tree. Run
    ``preprocess_split_fused_qkv(sd, r"attn_qkv|linear1_qkv")`` first for
    the fused projections (double blocks fuse qkv; single blocks fuse
    qkv+mlp inside linear1, which stays fused here as our layout matches).
    """
    dg = t_dense_general(heads)
    dgb = t_dense_general_bias(heads)
    rules: List[Tuple[str, str, Optional[Transform]]] = [
        (r"img_in\.proj\.weight", r"img_in/kernel", t_conv),
        (r"img_in\.proj\.bias", r"img_in/bias", None),
        (r"time_in\.mlp\.0\.weight", r"t_embedder/fc1/kernel", t_linear),
        (r"time_in\.mlp\.0\.bias", r"t_embedder/fc1/bias", None),
        (r"time_in\.mlp\.2\.weight", r"t_embedder/fc2/kernel", t_linear),
        (r"time_in\.mlp\.2\.bias", r"t_embedder/fc2/bias", None),
        (r"vector_in\.in_layer\.weight", r"vector_in/kernel", t_linear),
        (r"vector_in\.in_layer\.bias", r"vector_in/bias", None),
        (r"vector_in\.out_layer\.weight", r"vector_in_out/kernel",
         t_linear),
        (r"vector_in\.out_layer\.bias", r"vector_in_out/bias", None),
        (r"guidance_in\.mlp\.0\.weight", r"guidance_in/fc1/kernel",
         t_linear),
        (r"guidance_in\.mlp\.0\.bias", r"guidance_in/fc1/bias", None),
        (r"guidance_in\.mlp\.2\.weight", r"guidance_in/fc2/kernel",
         t_linear),
        (r"guidance_in\.mlp\.2\.bias", r"guidance_in/fc2/bias", None),
        (r"final_layer\.linear\.weight", r"final_proj/kernel",
         t_cfirst_patch_rows(patch, out_ch)),
        (r"final_layer\.linear\.bias", r"final_proj/bias",
         t_cfirst_patch_rows(patch, out_ch)),
        (r"final_layer\.adaLN_modulation\.1\.weight",
         r"final_mod/kernel", t_linear),
        (r"final_layer\.adaLN_modulation\.1\.bias",
         r"final_mod/bias", None),
    ]
    for stream in ("img", "txt"):
        rules += [
            (rf"double_blocks\.(\d+)\.{stream}_mod\.linear\.weight",
             rf"double_\1/{stream}_mod/kernel", t_linear),
            (rf"double_blocks\.(\d+)\.{stream}_mod\.linear\.bias",
             rf"double_\1/{stream}_mod/bias", None),
            (rf"double_blocks\.(\d+)\.{stream}_attn_proj\.weight",
             rf"double_\1/{stream}_attn_out/kernel", t_linear),
            (rf"double_blocks\.(\d+)\.{stream}_attn_proj\.bias",
             rf"double_\1/{stream}_attn_out/bias", None),
            (rf"double_blocks\.(\d+)\.{stream}_attn_q_norm\.weight",
             rf"double_\1/{stream}_q_norm/scale", None),
            (rf"double_blocks\.(\d+)\.{stream}_attn_k_norm\.weight",
             rf"double_\1/{stream}_k_norm/scale", None),
            (rf"double_blocks\.(\d+)\.{stream}_mlp\.fc1\.weight",
             rf"double_\1/{stream}_mlp1/kernel", t_linear),
            (rf"double_blocks\.(\d+)\.{stream}_mlp\.fc1\.bias",
             rf"double_\1/{stream}_mlp1/bias", None),
            (rf"double_blocks\.(\d+)\.{stream}_mlp\.fc2\.weight",
             rf"double_\1/{stream}_mlp2/kernel", t_linear),
            (rf"double_blocks\.(\d+)\.{stream}_mlp\.fc2\.bias",
             rf"double_\1/{stream}_mlp2/bias", None),
        ]
        for p in "qkv":
            rules += [
                (rf"double_blocks\.(\d+)\.{stream}_attn_{p}\.weight",
                 rf"double_\1/{stream}_{p}/kernel", dg),
                (rf"double_blocks\.(\d+)\.{stream}_attn_{p}\.bias",
                 rf"double_\1/{stream}_{p}/bias", dgb),
            ]
    rules += [
        (r"single_blocks\.(\d+)\.linear1\.weight",
         r"single_\1/linear1/kernel", t_linear),
        (r"single_blocks\.(\d+)\.linear1\.bias",
         r"single_\1/linear1/bias", None),
        (r"single_blocks\.(\d+)\.linear2\.weight",
         r"single_\1/linear2/kernel", t_linear),
        (r"single_blocks\.(\d+)\.linear2\.bias",
         r"single_\1/linear2/bias", None),
        (r"single_blocks\.(\d+)\.q_norm\.weight",
         r"single_\1/q_norm/scale", None),
        (r"single_blocks\.(\d+)\.k_norm\.weight",
         r"single_\1/k_norm/scale", None),
        (r"single_blocks\.(\d+)\.modulation\.linear\.weight",
         r"single_\1/mod/kernel", t_linear),
        (r"single_blocks\.(\d+)\.modulation\.linear\.bias",
         r"single_\1/mod/bias", None),
    ]
    # txt_in token refiner (SingleTokenRefiner, token_refiner.py:164); the
    # per-block self_attn_qkv is split by preprocess_split_fused_qkv first.
    refiner = r"txt_in\.individual_token_refiner\.blocks"
    rules += [
        (r"txt_in\.input_embedder\.weight",
         r"txt_in/input_embedder/kernel", t_linear),
        (r"txt_in\.input_embedder\.bias",
         r"txt_in/input_embedder/bias", None),
        (r"txt_in\.t_embedder\.mlp\.0\.weight",
         r"txt_in/t_embedder/fc1/kernel", t_linear),
        (r"txt_in\.t_embedder\.mlp\.0\.bias",
         r"txt_in/t_embedder/fc1/bias", None),
        (r"txt_in\.t_embedder\.mlp\.2\.weight",
         r"txt_in/t_embedder/fc2/kernel", t_linear),
        (r"txt_in\.t_embedder\.mlp\.2\.bias",
         r"txt_in/t_embedder/fc2/bias", None),
        (r"txt_in\.c_embedder\.linear_1\.weight",
         r"txt_in/c_embedder_1/kernel", t_linear),
        (r"txt_in\.c_embedder\.linear_1\.bias",
         r"txt_in/c_embedder_1/bias", None),
        (r"txt_in\.c_embedder\.linear_2\.weight",
         r"txt_in/c_embedder_2/kernel", t_linear),
        (r"txt_in\.c_embedder\.linear_2\.bias",
         r"txt_in/c_embedder_2/bias", None),
        (refiner + r"\.(\d+)\.norm1\.weight", r"txt_in/ln1_\1/scale", None),
        (refiner + r"\.(\d+)\.norm1\.bias", r"txt_in/ln1_\1/bias", None),
        (refiner + r"\.(\d+)\.norm2\.weight", r"txt_in/ln2_\1/scale", None),
        (refiner + r"\.(\d+)\.norm2\.bias", r"txt_in/ln2_\1/bias", None),
        (refiner + r"\.(\d+)\.self_attn_proj\.weight",
         r"txt_in/attn_out_\1/kernel", t_linear),
        (refiner + r"\.(\d+)\.self_attn_proj\.bias",
         r"txt_in/attn_out_\1/bias", None),
        (refiner + r"\.(\d+)\.mlp\.fc1\.weight",
         r"txt_in/fc1_\1/kernel", t_linear),
        (refiner + r"\.(\d+)\.mlp\.fc1\.bias",
         r"txt_in/fc1_\1/bias", None),
        (refiner + r"\.(\d+)\.mlp\.fc2\.weight",
         r"txt_in/fc2_\1/kernel", t_linear),
        (refiner + r"\.(\d+)\.mlp\.fc2\.bias",
         r"txt_in/fc2_\1/bias", None),
        (refiner + r"\.(\d+)\.adaLN_modulation\.1\.weight",
         r"txt_in/mod_\1/kernel", t_linear),
        (refiner + r"\.(\d+)\.adaLN_modulation\.1\.bias",
         r"txt_in/mod_\1/bias", None),
    ]
    for p in "qkv":
        rules += [
            (refiner + rf"\.(\d+)\.self_attn_{p}\.weight",
             rf"txt_in/{p}_\1/kernel", dg),
            (refiner + rf"\.(\d+)\.self_attn_{p}\.bias",
             rf"txt_in/{p}_\1/bias", dgb),
        ]
    return ConversionMap(rules)


def cogvideox_map(heads: int = 30) -> ConversionMap:
    """diffusers CogVideoXTransformer3DModel names → videotuna_tpu
    CogVideoXTransformer tree."""
    dg = t_dense_general(heads)
    dgb = t_dense_general_bias(heads)
    return ConversionMap([
        (r"patch_embed\.proj\.weight", r"patch_embed/kernel", t_conv),
        (r"patch_embed\.proj\.bias", r"patch_embed/bias", None),
        (r"patch_embed\.text_proj\.weight", r"text_proj/kernel", t_linear),
        (r"patch_embed\.text_proj\.bias", r"text_proj/bias", None),
        (r"time_embedding\.linear_1\.weight", r"t_embedder/fc1/kernel",
         t_linear),
        (r"time_embedding\.linear_1\.bias", r"t_embedder/fc1/bias", None),
        (r"time_embedding\.linear_2\.weight", r"t_embedder/fc2/kernel",
         t_linear),
        (r"time_embedding\.linear_2\.bias", r"t_embedder/fc2/bias", None),
        (r"transformer_blocks\.(\d+)\.norm1\.linear\.weight",
         r"block_\1/norm1_mod/kernel", t_linear),
        (r"transformer_blocks\.(\d+)\.norm1\.linear\.bias",
         r"block_\1/norm1_mod/bias", None),
        (r"transformer_blocks\.(\d+)\.norm2\.linear\.weight",
         r"block_\1/norm2_mod/kernel", t_linear),
        (r"transformer_blocks\.(\d+)\.norm2\.linear\.bias",
         r"block_\1/norm2_mod/bias", None),
        (r"transformer_blocks\.(\d+)\.attn1\.to_q\.weight",
         r"block_\1/q/kernel", dg),
        (r"transformer_blocks\.(\d+)\.attn1\.to_q\.bias",
         r"block_\1/q/bias", dgb),
        (r"transformer_blocks\.(\d+)\.attn1\.to_k\.weight",
         r"block_\1/k/kernel", dg),
        (r"transformer_blocks\.(\d+)\.attn1\.to_k\.bias",
         r"block_\1/k/bias", dgb),
        (r"transformer_blocks\.(\d+)\.attn1\.to_v\.weight",
         r"block_\1/v/kernel", dg),
        (r"transformer_blocks\.(\d+)\.attn1\.to_v\.bias",
         r"block_\1/v/bias", dgb),
        (r"transformer_blocks\.(\d+)\.attn1\.norm_q\.weight",
         r"block_\1/q_norm/scale", None),
        (r"transformer_blocks\.(\d+)\.attn1\.norm_q\.bias",
         r"block_\1/q_norm/bias", None),
        (r"transformer_blocks\.(\d+)\.attn1\.norm_k\.weight",
         r"block_\1/k_norm/scale", None),
        (r"transformer_blocks\.(\d+)\.attn1\.norm_k\.bias",
         r"block_\1/k_norm/bias", None),
        (r"transformer_blocks\.(\d+)\.attn1\.to_out\.0\.weight",
         r"block_\1/attn_out/kernel", t_linear),
        (r"transformer_blocks\.(\d+)\.attn1\.to_out\.0\.bias",
         r"block_\1/attn_out/bias", None),
        (r"transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.weight",
         r"block_\1/ff1/kernel", t_linear),
        (r"transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.bias",
         r"block_\1/ff1/bias", None),
        (r"transformer_blocks\.(\d+)\.ff\.net\.2\.weight",
         r"block_\1/ff2/kernel", t_linear),
        (r"transformer_blocks\.(\d+)\.ff\.net\.2\.bias",
         r"block_\1/ff2/bias", None),
        (r"norm_final\.weight", r"norm_final/scale", None),
        (r"norm_final\.bias", r"norm_final/bias", None),
        (r"norm_out\.linear\.weight", r"adaln_out/kernel", t_linear),
        (r"norm_out\.linear\.bias", r"adaln_out/bias", None),
        (r"proj_out\.weight", r"proj_out/kernel", t_linear),
        (r"proj_out\.bias", r"proj_out/bias", None),
        (r"patch_embed\.pos_embedding", r"pos_embed",
         lambda w: w.reshape(w.shape[-2], w.shape[-1])),
    ])


def _squeeze(a: np.ndarray) -> np.ndarray:
    return a.reshape(-1)


def _conv1x1_to_dense(w: np.ndarray) -> np.ndarray:
    """torch Conv2d 1×1 (out, in, 1, 1) → flax Dense kernel (in, out)."""
    return np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)


def wan_vae_map() -> ConversionMap:
    """Wan 2.1 VAE torch names (models/wan/wan/modules/vae.py WanVAE_
    state_dict) → videotuna_tpu models/wan/vae.WanVAE tree.

    torch Sequential indices map to named children: residual.{0,2,3,6} →
    norm1/conv1/norm2/conv2; head.{0,2} → head_norm/head_conv;
    resample.1 → resample_conv.  RMS_norm gammas (C,1,1[,1]) flatten to
    (C,); AttentionBlock 1×1 Conv2d projections become Dense kernels.
    Encoder time_convs (downsample3d) are plain convs; decoder time_convs
    (upsample3d) are CausalConv3d and nest one level deeper.
    """
    rules: List[Tuple[str, str, Optional[Transform]]] = []
    for coder, stages in (("encoder", "downsamples"),
                          ("decoder", "upsamples")):
        for group, path in ((rf"{stages}\.(\d+)", rf"{stages}_\1"),
                            (r"middle\.(\d+)", r"middle_\1")):
            rules += [
                # ResidualBlock
                (rf"{coder}\.{group}\.residual\.0\.gamma",
                 rf"{coder}/{path}/norm1/gamma", _squeeze),
                (rf"{coder}\.{group}\.residual\.2\.weight",
                 rf"{coder}/{path}/conv1/conv/kernel", t_conv),
                (rf"{coder}\.{group}\.residual\.2\.bias",
                 rf"{coder}/{path}/conv1/conv/bias", None),
                (rf"{coder}\.{group}\.residual\.3\.gamma",
                 rf"{coder}/{path}/norm2/gamma", _squeeze),
                (rf"{coder}\.{group}\.residual\.6\.weight",
                 rf"{coder}/{path}/conv2/conv/kernel", t_conv),
                (rf"{coder}\.{group}\.residual\.6\.bias",
                 rf"{coder}/{path}/conv2/conv/bias", None),
                (rf"{coder}\.{group}\.shortcut\.weight",
                 rf"{coder}/{path}/shortcut/conv/kernel", t_conv),
                (rf"{coder}\.{group}\.shortcut\.bias",
                 rf"{coder}/{path}/shortcut/conv/bias", None),
                # AttentionBlock
                (rf"{coder}\.{group}\.norm\.gamma",
                 rf"{coder}/{path}/norm/gamma", _squeeze),
                (rf"{coder}\.{group}\.to_qkv\.weight",
                 rf"{coder}/{path}/to_qkv/kernel", _conv1x1_to_dense),
                (rf"{coder}\.{group}\.to_qkv\.bias",
                 rf"{coder}/{path}/to_qkv/bias", None),
                (rf"{coder}\.{group}\.proj\.weight",
                 rf"{coder}/{path}/proj/kernel", _conv1x1_to_dense),
                (rf"{coder}\.{group}\.proj\.bias",
                 rf"{coder}/{path}/proj/bias", None),
            ]
        # Resample spatial conv (Sequential index 1 in both directions)
        rules += [
            (rf"{coder}\.{stages}\.(\d+)\.resample\.1\.weight",
             rf"{coder}/{stages}_\1/resample_conv/kernel", t_conv),
            (rf"{coder}\.{stages}\.(\d+)\.resample\.1\.bias",
             rf"{coder}/{stages}_\1/resample_conv/bias", None),
            # coder conv1 / head
            (rf"{coder}\.conv1\.weight", rf"{coder}/conv1/conv/kernel",
             t_conv),
            (rf"{coder}\.conv1\.bias", rf"{coder}/conv1/conv/bias", None),
            (rf"{coder}\.head\.0\.gamma", rf"{coder}/head_norm/gamma",
             _squeeze),
            (rf"{coder}\.head\.2\.weight", rf"{coder}/head_conv/conv/kernel",
             t_conv),
            (rf"{coder}\.head\.2\.bias", rf"{coder}/head_conv/conv/bias",
             None),
        ]
    rules += [
        # downsample3d time conv: plain nn.Conv in WanResample
        (r"encoder\.downsamples\.(\d+)\.time_conv\.weight",
         r"encoder/downsamples_\1/time_conv/kernel", t_conv),
        (r"encoder\.downsamples\.(\d+)\.time_conv\.bias",
         r"encoder/downsamples_\1/time_conv/bias", None),
        # upsample3d time conv: WanCausalConv3d (nested /conv)
        (r"decoder\.upsamples\.(\d+)\.time_conv\.weight",
         r"decoder/upsamples_\1/time_conv/conv/kernel", t_conv),
        (r"decoder\.upsamples\.(\d+)\.time_conv\.bias",
         r"decoder/upsamples_\1/time_conv/conv/bias", None),
        # top-level moment/latent 1×1×1 convs
        (r"conv1\.weight", r"conv1/conv/kernel", t_conv),
        (r"conv1\.bias", r"conv1/conv/bias", None),
        (r"conv2\.weight", r"conv2/conv/kernel", t_conv),
        (r"conv2\.bias", r"conv2/conv/bias", None),
    ]
    return ConversionMap(rules)


def hunyuan_vae_map() -> ConversionMap:
    """HunyuanVideo AutoencoderKLCausal3D torch checkpoint names →
    videotuna_tpu models/hunyuan/vae.HunyuanVAE tree (reference naming:
    hyvideo_i2v/vae/vae.py — e.g.
    ``encoder.down_blocks.0.resnets.0.conv1.conv.weight``)."""
    rules: List[Tuple[str, str, Optional[Transform]]] = []

    def resnet(src: str, dst: str):
        out = []
        for norm in ("norm1", "norm2"):
            out += [
                (rf"{src}\.{norm}\.weight", rf"{dst}/{norm}/scale", None),
                (rf"{src}\.{norm}\.bias", rf"{dst}/{norm}/bias", None),
            ]
        for conv in ("conv1", "conv2", "conv_shortcut"):
            out += [
                (rf"{src}\.{conv}\.conv\.weight",
                 rf"{dst}/{conv}/conv/kernel", t_conv),
                (rf"{src}\.{conv}\.conv\.bias",
                 rf"{dst}/{conv}/conv/bias", None),
            ]
        return out

    for coder, blocks, stage in (("encoder", "down_blocks", "down"),
                                 ("decoder", "up_blocks", "up")):
        rules += resnet(rf"{coder}\.{blocks}\.(\d+)\.resnets\.(\d+)",
                        rf"{coder}/{stage}_\1_res_\2")
        rules += resnet(rf"{coder}\.mid_block\.resnets\.(\d+)",
                        rf"{coder}/mid/resnet_\1")
        attn = rf"{coder}\.mid_block\.attentions\.0"
        mid = rf"{coder}/mid"
        rules += [
            (rf"{attn}\.group_norm\.weight",
             rf"{mid}/attention_0/group_norm/scale", None),
            (rf"{attn}\.group_norm\.bias",
             rf"{mid}/attention_0/group_norm/bias", None),
            (rf"{attn}\.to_(q|k|v)\.weight",
             rf"{mid}/attention_0/to_\1/kernel", t_linear),
            (rf"{attn}\.to_(q|k|v)\.bias",
             rf"{mid}/attention_0/to_\1/bias", None),
            (rf"{attn}\.to_out\.0\.weight",
             rf"{mid}/attention_0/to_out/kernel", t_linear),
            (rf"{attn}\.to_out\.0\.bias",
             rf"{mid}/attention_0/to_out/bias", None),
        ]
        rules += [
            (rf"{coder}\.conv_in\.conv\.weight",
             rf"{coder}/conv_in/conv/kernel", t_conv),
            (rf"{coder}\.conv_in\.conv\.bias",
             rf"{coder}/conv_in/conv/bias", None),
            (rf"{coder}\.conv_norm_out\.weight",
             rf"{coder}/norm_out/scale", None),
            (rf"{coder}\.conv_norm_out\.bias",
             rf"{coder}/norm_out/bias", None),
            (rf"{coder}\.conv_out\.conv\.weight",
             rf"{coder}/conv_out/conv/kernel", t_conv),
            (rf"{coder}\.conv_out\.conv\.bias",
             rf"{coder}/conv_out/conv/bias", None),
        ]
    rules += [
        (r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.conv"
         r"\.weight", r"encoder/down_\1_downsampler/conv/kernel", t_conv),
        (r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.conv"
         r"\.bias", r"encoder/down_\1_downsampler/conv/bias", None),
        (r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.conv\.weight",
         r"decoder/up_\1_upsampler/conv/conv/kernel", t_conv),
        (r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.conv\.bias",
         r"decoder/up_\1_upsampler/conv/conv/bias", None),
        (r"quant_conv\.weight", r"quant_conv/kernel", t_conv),
        (r"quant_conv\.bias", r"quant_conv/bias", None),
        (r"post_quant_conv\.weight", r"post_quant_conv/kernel", t_conv),
        (r"post_quant_conv\.bias", r"post_quant_conv/bias", None),
    ]
    return ConversionMap(rules)


def cogvideox_vae_map() -> ConversionMap:
    """CogVideoX SAT VAE torch names (cogvideo_sat/vae_modules/
    cp_enc_dec.py state_dict, e.g. ``encoder.down.0.block.0.conv1.conv
    .weight``) → videotuna_tpu models/cogvideo/vae.CogVideoXVAE tree."""
    rules: List[Tuple[str, str, Optional[Transform]]] = []

    def resnet(src: str, dst: str, spatial_norm: bool):
        out = []
        for norm in ("norm1", "norm2"):
            if spatial_norm:
                out += [
                    (rf"{src}\.{norm}\.norm_layer\.weight",
                     rf"{dst}/{norm}/norm_layer/scale", None),
                    (rf"{src}\.{norm}\.norm_layer\.bias",
                     rf"{dst}/{norm}/norm_layer/bias", None),
                    (rf"{src}\.{norm}\.conv_(?P<yb>y|b)\.conv\.weight",
                     rf"{dst}/{norm}/conv_\g<yb>/conv/kernel", t_conv),
                    (rf"{src}\.{norm}\.conv_(?P<yb>y|b)\.conv\.bias",
                     rf"{dst}/{norm}/conv_\g<yb>/conv/bias", None),
                ]
            else:
                out += [
                    (rf"{src}\.{norm}\.weight", rf"{dst}/{norm}/scale",
                     None),
                    (rf"{src}\.{norm}\.bias", rf"{dst}/{norm}/bias", None),
                ]
        out += [
            (rf"{src}\.conv(?P<ci>1|2)\.conv\.weight",
             rf"{dst}/conv\g<ci>/conv/kernel", t_conv),
            (rf"{src}\.conv(?P<ci>1|2)\.conv\.bias",
             rf"{dst}/conv\g<ci>/conv/bias", None),
            (rf"{src}\.nin_shortcut\.weight", rf"{dst}/nin_shortcut/kernel",
             t_conv),
            (rf"{src}\.nin_shortcut\.bias", rf"{dst}/nin_shortcut/bias",
             None),
        ]
        return out

    # encoder (plain GroupNorm)
    rules += resnet(r"encoder\.down\.(\d+)\.block\.(\d+)",
                    r"encoder/down_\1_block_\2", False)
    rules += resnet(r"encoder\.mid\.block_(\d+)", r"encoder/mid_block_\1",
                    False)
    rules += [
        (r"encoder\.down\.(\d+)\.downsample\.conv\.weight",
         r"encoder/down_\1_downsample/conv/kernel", t_conv),
        (r"encoder\.down\.(\d+)\.downsample\.conv\.bias",
         r"encoder/down_\1_downsample/conv/bias", None),
        (r"encoder\.conv_in\.conv\.weight", r"encoder/conv_in/conv/kernel",
         t_conv),
        (r"encoder\.conv_in\.conv\.bias", r"encoder/conv_in/conv/bias",
         None),
        (r"encoder\.norm_out\.weight", r"encoder/norm_out/scale", None),
        (r"encoder\.norm_out\.bias", r"encoder/norm_out/bias", None),
        (r"encoder\.conv_out\.conv\.weight",
         r"encoder/conv_out/conv/kernel", t_conv),
        (r"encoder\.conv_out\.conv\.bias", r"encoder/conv_out/conv/bias",
         None),
    ]
    # decoder (zq-conditioned SpatialNorm3D everywhere)
    rules += resnet(r"decoder\.up\.(\d+)\.block\.(\d+)",
                    r"decoder/up_\1_block_\2", True)
    rules += resnet(r"decoder\.mid\.block_(\d+)", r"decoder/mid_block_\1",
                    True)
    rules += [
        (r"decoder\.up\.(\d+)\.upsample\.conv\.weight",
         r"decoder/up_\1_upsample/conv/kernel", t_conv),
        (r"decoder\.up\.(\d+)\.upsample\.conv\.bias",
         r"decoder/up_\1_upsample/conv/bias", None),
        (r"decoder\.conv_in\.conv\.weight", r"decoder/conv_in/conv/kernel",
         t_conv),
        (r"decoder\.conv_in\.conv\.bias", r"decoder/conv_in/conv/bias",
         None),
        (r"decoder\.norm_out\.norm_layer\.weight",
         r"decoder/norm_out/norm_layer/scale", None),
        (r"decoder\.norm_out\.norm_layer\.bias",
         r"decoder/norm_out/norm_layer/bias", None),
        (r"decoder\.norm_out\.conv_(y|b)\.conv\.weight",
         r"decoder/norm_out/conv_\1/conv/kernel", t_conv),
        (r"decoder\.norm_out\.conv_(y|b)\.conv\.bias",
         r"decoder/norm_out/conv_\1/conv/bias", None),
        (r"decoder\.conv_out\.conv\.weight",
         r"decoder/conv_out/conv/kernel", t_conv),
        (r"decoder\.conv_out\.conv\.bias", r"decoder/conv_out/conv/bias",
         None),
    ]
    return ConversionMap(rules)


# ---------------------------------------------------------------------------
# Text-encoder maps (HF transformers torch checkpoints → our flax encoders).
# Numerically gated in tests/test_text_encoder_parity.py against the actual
# transformers torch models (the reference loads these exact checkpoints:
# opensora t5.py, wan modules/t5.py:456, hyvideo text_encoder/__init__.py:610,
# lvdm condition.py FrozenOpenCLIPEmbedder).
# ---------------------------------------------------------------------------

def _identity(a: np.ndarray) -> np.ndarray:
    return a


def t5_map(heads: int) -> ConversionMap:
    """HF T5EncoderModel state_dict → videotuna_tpu T5Encoder tree."""
    dg = t_dense_general(heads)
    blk = r"encoder\.block\.(\d+)\.layer"
    return ConversionMap([
        (r"shared\.weight", r"token_embed/embedding", _identity),
        (r"encoder\.embed_tokens\.weight", r"token_embed/embedding",
         _identity),
        (r"encoder\.block\.0\.layer\.0\.SelfAttention"
         r"\.relative_attention_bias\.weight", r"rel_bias", _identity),
        (rf"{blk}\.0\.SelfAttention\.(q|k|v)\.weight",
         r"block_\1/attn/\2/kernel", dg),
        (rf"{blk}\.0\.SelfAttention\.o\.weight",
         r"block_\1/attn/o/kernel", t_linear),
        (rf"{blk}\.0\.layer_norm\.weight", r"block_\1/norm1/scale", None),
        (rf"{blk}\.1\.DenseReluDense\.wi_0\.weight",
         r"block_\1/wi_0/kernel", t_linear),
        (rf"{blk}\.1\.DenseReluDense\.wi_1\.weight",
         r"block_\1/wi_1/kernel", t_linear),
        (rf"{blk}\.1\.DenseReluDense\.wo\.weight",
         r"block_\1/wo/kernel", t_linear),
        (rf"{blk}\.1\.layer_norm\.weight", r"block_\1/norm2/scale", None),
        (r"encoder\.final_layer_norm\.weight", r"final_norm/scale", None),
    ])


def clip_text_map(heads: int) -> ConversionMap:
    """HF CLIPTextModel state_dict (``text_model.`` prefix) →
    videotuna_tpu CLIPTextEncoder tree."""
    dg = t_dense_general(heads)
    dgb = t_dense_general_bias(heads)
    lyr = r"text_model\.encoder\.layers\.(\d+)"
    return ConversionMap([
        (r"text_model\.embeddings\.token_embedding\.weight",
         r"token_embed/embedding", _identity),
        (r"text_model\.embeddings\.position_embedding\.weight",
         r"pos_embed", _identity),
        (rf"{lyr}\.layer_norm1\.weight", r"block_\1/ln1/scale", None),
        (rf"{lyr}\.layer_norm1\.bias", r"block_\1/ln1/bias", None),
        (rf"{lyr}\.self_attn\.(q|k|v)_proj\.weight",
         r"block_\1/\2/kernel", dg),
        (rf"{lyr}\.self_attn\.(q|k|v)_proj\.bias",
         r"block_\1/\2/bias", dgb),
        (rf"{lyr}\.self_attn\.out_proj\.weight",
         r"block_\1/attn_out/kernel", t_linear),
        (rf"{lyr}\.self_attn\.out_proj\.bias",
         r"block_\1/attn_out/bias", None),
        (rf"{lyr}\.layer_norm2\.weight", r"block_\1/ln2/scale", None),
        (rf"{lyr}\.layer_norm2\.bias", r"block_\1/ln2/bias", None),
        (rf"{lyr}\.mlp\.fc(1|2)\.weight", r"block_\1/fc\2/kernel",
         t_linear),
        (rf"{lyr}\.mlp\.fc(1|2)\.bias", r"block_\1/fc\2/bias", None),
        (r"text_model\.final_layer_norm\.weight", r"ln_final/scale", None),
        (r"text_model\.final_layer_norm\.bias", r"ln_final/bias", None),
    ])


def llama_map(heads: int, kv_heads: Optional[int] = None) -> ConversionMap:
    """HF LlamaModel state_dict → videotuna_tpu LlamaTextEncoder tree."""
    dg = t_dense_general(heads)
    dgkv = t_dense_general(kv_heads or heads)
    lyr = r"(?:model\.)?layers\.(\d+)"
    return ConversionMap([
        (r"(?:model\.)?embed_tokens\.weight", r"token_embed/embedding",
         _identity),
        (rf"{lyr}\.input_layernorm\.weight", r"block_\1/attn_norm/scale",
         None),
        (rf"{lyr}\.self_attn\.q_proj\.weight", r"block_\1/q/kernel", dg),
        (rf"{lyr}\.self_attn\.k_proj\.weight", r"block_\1/k/kernel", dgkv),
        (rf"{lyr}\.self_attn\.v_proj\.weight", r"block_\1/v/kernel", dgkv),
        (rf"{lyr}\.self_attn\.o_proj\.weight", r"block_\1/o/kernel",
         t_linear),
        (rf"{lyr}\.post_attention_layernorm\.weight",
         r"block_\1/mlp_norm/scale", None),
        (rf"{lyr}\.mlp\.gate_proj\.weight", r"block_\1/gate/kernel",
         t_linear),
        (rf"{lyr}\.mlp\.up_proj\.weight", r"block_\1/up/kernel", t_linear),
        (rf"{lyr}\.mlp\.down_proj\.weight", r"block_\1/down/kernel",
         t_linear),
        (r"(?:model\.)?norm\.weight", r"final_norm/scale", None),
        (r"lm_head\.weight", r"lm_head/kernel", t_linear),
    ])


def stack_blocks_for_scan(tree: Dict[str, Any], prefix: str = "block_",
                          out_key: str = "blocks",
                          exclude: Sequence[int] = ()) -> Dict[str, Any]:
    """Convert per-block entries (block_0..block_N) into the stacked layout
    nn.scan expects. ``exclude`` keeps the named indices un-stacked (e.g.
    Mochi's final update_y=False block, whose params differ in shape)."""
    skip = set(exclude)
    idxs = sorted(int(k[len(prefix):]) for k in tree
                  if k.startswith(prefix) and k[len(prefix):].isdigit()
                  and int(k[len(prefix):]) not in skip)
    if not idxs:
        return tree
    blocks = [tree[f"{prefix}{i}"] for i in idxs]
    stacked = _stack_trees(blocks)
    out = {k: v for k, v in tree.items()
           if not (k.startswith(prefix) and k[len(prefix):].isdigit()
                   and int(k[len(prefix):]) not in skip)}
    out[out_key] = stacked
    return out


def _stack_trees(trees: Sequence[Any]) -> Any:
    """The trees' leaves stacked on a new leading axis, tree by tree."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(x) for x in trees])


def convert_lora_safetensors(sd: Dict[str, np.ndarray],
                             rank_key: str = "lora"
                             ) -> Dict[str, Dict[str, np.ndarray]]:
    """peft/safetensors LoRA (lora_A/lora_B or lora_down/lora_up) → our
    {path: {"a", "b"}} delta-tree layout (reference convert_lora,
    load_weights.py:331)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, val in sd.items():
        low = name.lower()
        if "lora_a" in low or "lora_down" in low:
            key = re.sub(r"\.lora_(a|down)(\.weight)?$", "", name,
                         flags=re.I)
            out.setdefault(key, {})["a"] = t_linear(val)
        elif "lora_b" in low or "lora_up" in low:
            key = re.sub(r"\.lora_(b|up)(\.weight)?$", "", name,
                         flags=re.I)
            out.setdefault(key, {})["b"] = t_linear(val)
    return out


# ---------------------------------------------------------------------------
# lvdm / VideoCrafter UNet3D map (generated by replaying the reference
# UNetModel enumeration — openaimodel3d.py:411-560)
# ---------------------------------------------------------------------------

def _t_conv2d_as_133(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (out, in, kh, kw) → our (1, kh, kw, in, out) video
    conv."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))[None]


def _t_conv1x1_as_111(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))[None]


def _t_conv3d(w: np.ndarray) -> np.ndarray:
    """torch Conv3d (out, in, kt, kh, kw) → (kt, kh, kw, in, out)."""
    return np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0))


def _t_conv1d_lin(w: np.ndarray) -> np.ndarray:
    """Conv1d k=1 (out, in, 1) → Dense kernel (in, out)."""
    return np.ascontiguousarray(w[:, :, 0].T)


def lvdm_map(model_channels: int = 320,
             channel_mult: Sequence[int] = (1, 2, 4, 4),
             num_res_blocks: int = 2,
             attention_resolutions: Sequence[int] = (4, 2, 1),
             num_head_channels: int = 64,
             temporal_conv: bool = True,
             temporal_attention: bool = True,
             addition_attention: bool = False,
             use_relative_position: bool = False,
             use_image_attention: bool = False,
             use_scale_shift_norm: bool = False) -> ConversionMap:
    """VideoCrafter1/2 / DynamiCrafter ``UNetModel`` state dict →
    videotuna_tpu UNet3D tree. Rules are generated by replaying the
    reference block enumeration, so input_blocks.N indices line up with
    our down_res_i / spatial_down_i / temporal_down_i / downsample_level
    names for the given config."""
    rules: List[Tuple[str, str, Optional[Transform]]] = []

    def lin(t_prefix, o_path):
        rules.append((re.escape(t_prefix) + r"\.weight", o_path + "/kernel",
                      t_linear))
        rules.append((re.escape(t_prefix) + r"\.bias", o_path + "/bias",
                      None))

    def norm(t_prefix, o_path):
        rules.append((re.escape(t_prefix) + r"\.weight", o_path + "/scale",
                      None))
        rules.append((re.escape(t_prefix) + r"\.bias", o_path + "/bias",
                      None))

    def conv2d(t_prefix, o_path, one_by_one=False):
        fn = _t_conv1x1_as_111 if one_by_one else _t_conv2d_as_133
        rules.append((re.escape(t_prefix) + r"\.weight", o_path + "/kernel",
                      fn))
        rules.append((re.escape(t_prefix) + r"\.bias", o_path + "/bias",
                      None))

    def resblock(t, o):
        norm(f"{t}.in_layers.0", f"{o}/norm1/gn")
        conv2d(f"{t}.in_layers.2", f"{o}/conv1")
        lin(f"{t}.emb_layers.1", f"{o}/emb_proj")
        norm(f"{t}.out_layers.0", f"{o}/norm2/gn")
        conv2d(f"{t}.out_layers.3", f"{o}/conv2")
        conv2d(f"{t}.skip_connection", f"{o}/skip", one_by_one=True)
        if temporal_conv:
            for i in range(1, 5):
                norm(f"{t}.temopral_conv.conv{i}.0", f"{o}/tconv/norm{i}")
                ci = 2 if i == 1 else 3
                rules.append((re.escape(f"{t}.temopral_conv.conv{i}.{ci}")
                              + r"\.weight", f"{o}/tconv/conv{i}/kernel",
                              _t_conv3d))
                rules.append((re.escape(f"{t}.temopral_conv.conv{i}.{ci}")
                              + r"\.bias", f"{o}/tconv/conv{i}/bias", None))

    def attn(t, o, heads, extra_q_prefix=True):
        dg = t_dense_general(heads)
        for p in "qkv":
            rules.append((re.escape(f"{t}.to_{p}") + r"\.weight",
                          f"{o}_{p}/kernel", dg))
        lin(f"{t}.to_out.0", f"{o}_out")

    def spatial(t, o_tag, heads):
        norm(f"{t}.norm", f"spatial_{o_tag}/norm/gn")
        lin(f"{t}.proj_in", f"spatial_{o_tag}/proj_in")
        tb = f"{t}.transformer_blocks.0"
        attn(f"{tb}.attn1", f"spatial_{o_tag}/attn1", heads)
        attn(f"{tb}.attn2", f"spatial_{o_tag}/attn2", heads)
        if use_image_attention:
            dgx = t_dense_general(heads)
            for p in ("k_ip", "v_ip"):
                rules.append((re.escape(f"{tb}.attn2.to_{p}")
                              + r"\.weight",
                              f"spatial_{o_tag}/attn2_{p}/kernel", dgx))
        for i in (1, 2, 3):
            norm(f"{tb}.norm{i}", f"spatial_{o_tag}/ln{i}")
        lin(f"{tb}.ff.net.0.proj", f"spatial_{o_tag}/geglu")
        lin(f"{tb}.ff.net.2", f"spatial_{o_tag}/mlp_out")
        lin(f"{t}.proj_out", f"spatial_{o_tag}/proj_out")

    def temporal(t, o_name, heads, linear_proj=True):
        norm(f"{t}.norm", f"{o_name}/norm")
        if linear_proj:
            lin(f"{t}.proj_in", f"{o_name}/proj_in")
            lin(f"{t}.proj_out", f"{o_name}/proj_out")
        else:   # init_attn uses Conv1d k=1
            rules.append((re.escape(f"{t}.proj_in") + r"\.weight",
                          f"{o_name}/proj_in/kernel", _t_conv1d_lin))
            rules.append((re.escape(f"{t}.proj_in") + r"\.bias",
                          f"{o_name}/proj_in/bias", None))
            rules.append((re.escape(f"{t}.proj_out") + r"\.weight",
                          f"{o_name}/proj_out/kernel", _t_conv1d_lin))
            rules.append((re.escape(f"{t}.proj_out") + r"\.bias",
                          f"{o_name}/proj_out/bias", None))
        tb = f"{t}.transformer_blocks.0"
        for a, ln in (("attn1", "ln_attn1"), ("attn2", "ln_attn2")):
            attn(f"{tb}.{a}", f"{o_name}/{a}", heads)
            if use_relative_position:
                rules.append((re.escape(
                    f"{tb}.{a}.relative_position_k.embeddings_table"),
                    f"{o_name}/{a}_rel_k", _identity))
                rules.append((re.escape(
                    f"{tb}.{a}.relative_position_v.embeddings_table"),
                    f"{o_name}/{a}_rel_v", _identity))
        norm(f"{tb}.norm1", f"{o_name}/ln_attn1")
        norm(f"{tb}.norm2", f"{o_name}/ln_attn2")
        norm(f"{tb}.norm3", f"{o_name}/ln3")
        lin(f"{tb}.ff.net.0.proj", f"{o_name}/geglu")
        lin(f"{tb}.ff.net.2", f"{o_name}/mlp_out")

    # --- top-level embeds + conv_in
    lin("time_embed.0", "time_fc1")
    lin("time_embed.2", "time_fc2")
    lin("fps_embedding.0", "fps_fc1")
    lin("fps_embedding.2", "fps_fc2")
    conv2d("input_blocks.0.0", "conv_in")
    if addition_attention:
        temporal("init_attn.0", "init_attn", heads=8, linear_proj=False)

    # --- down path (replay of openaimodel3d.py:436-512)
    n = 1
    ds = 1
    idx = 0
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            ch = mult * model_channels
            heads = ch // num_head_channels
            resblock(f"input_blocks.{n}.0", f"down_res_{idx}")
            if ds in attention_resolutions:
                spatial(f"input_blocks.{n}.1", f"down_{idx}", heads)
                if temporal_attention:
                    temporal(f"input_blocks.{n}.2",
                             f"temporal_down_{idx}", heads)
            n += 1
            idx += 1
        if level != len(channel_mult) - 1:
            conv2d(f"input_blocks.{n}.0.op", f"downsample_{level}")
            n += 1
            ds *= 2

    # --- middle
    ch = channel_mult[-1] * model_channels
    heads = ch // num_head_channels
    resblock("middle_block.0", "mid_res_1")
    spatial("middle_block.1", "mid", heads)
    k = 2
    if temporal_attention:
        temporal(f"middle_block.{k}", "temporal_mid", heads)
        k += 1
    resblock(f"middle_block.{k}", "mid_res_2")

    # --- up path (reverse levels, num_res_blocks+1 each, upsample at end)
    n = 0
    idx = 0
    for level, mult in reversed(list(enumerate(channel_mult))):
        for i in range(num_res_blocks + 1):
            ch = mult * model_channels
            heads = ch // num_head_channels
            resblock(f"output_blocks.{n}.0", f"up_res_{idx}")
            m = 1
            if ds in attention_resolutions:
                spatial(f"output_blocks.{n}.{m}", f"up_{idx}", heads)
                m += 1
                if temporal_attention:
                    temporal(f"output_blocks.{n}.{m}",
                             f"temporal_up_{idx}", heads)
                    m += 1
            if level != 0 and i == num_res_blocks:
                conv2d(f"output_blocks.{n}.{m}.conv", f"upsample_{level}")
                ds //= 2
            n += 1
            idx += 1

    norm("out.0", "norm_out/gn")
    conv2d("out.2", "conv_out")
    return ConversionMap(rules)


# ---------------------------------------------------------------------------
# StepVideo (the DiT and the Step-1 LLM) and Mochi
# ---------------------------------------------------------------------------

def stepllm_map() -> ConversionMap:
    """StepVideo Step1Model state_dict (stepllm.py: tok_embeddings +
    transformer.layers.N.{attention.wqkv/wo, feed_forward.w1/w2,
    attention_norm, ffn_norm}) → the StepLLMEncoder tree."""
    lyr = r"transformer\.layers\.(\d+)"
    return ConversionMap([
        (r"tok_embeddings\.word_embeddings\.weight",
         r"tok_embeddings/embedding", _identity),
        (rf"{lyr}\.attention\.wqkv\.weight", r"block_\1/wqkv/kernel",
         t_linear),
        (rf"{lyr}\.attention\.wo\.weight", r"block_\1/wo/kernel",
         t_linear),
        (rf"{lyr}\.attention_norm\.weight", r"block_\1/attn_norm/scale",
         None),
        (rf"{lyr}\.ffn_norm\.weight", r"block_\1/ffn_norm/scale", None),
        (rf"{lyr}\.feed_forward\.w1\.weight", r"block_\1/w1/kernel",
         t_linear),
        (rf"{lyr}\.feed_forward\.w2\.weight", r"block_\1/w2/kernel",
         t_linear),
    ])


def preprocess_split_headwise(sd: Dict[str, np.ndarray],
                              pattern: str, token: str,
                              names: Sequence[str],
                              heads: int) -> Dict[str, np.ndarray]:
    """Split PER-HEAD-INTERLEAVED fused projections (StepVideo model.py
    :485-495 / :536-539: ``view(..., heads, n·hd)`` then ``split(hd)`` —
    output rows ordered head-major as [q|k|v] chunks within each head,
    unlike the block layout preprocess_split_fused handles)."""
    rx = re.compile(pattern)
    n = len(names)
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if rx.search(key) and token in key:
            if val.shape[0] % (heads * n):
                raise ValueError(
                    f"{key}: {val.shape[0]} output rows not divisible by "
                    f"heads({heads})×{n} — wrong --heads? (StepVideo-30B "
                    f"uses 48)")
            hd = val.shape[0] // (heads * n)
            if hd % 2:
                raise ValueError(
                    f"{key}: implied head_dim {hd} is odd — wrong --heads "
                    f"(StepVideo-30B uses 48, head_dim 128)")
            parts = val.reshape(heads, n, hd, *val.shape[1:])
            for i, name in enumerate(names):
                out[key.replace(token, name)] = np.ascontiguousarray(
                    parts[:, i].reshape(heads * hd, *val.shape[1:]))
        else:
            out[key] = val
    return out


def _t_conv2d_to_patch3d(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (out, in, kh, kw) → flax 3D patch kernel
    (1, kh, kw, in, out) (StepVideo patchfy runs the 2D PatchEmbed per
    frame, model.py:816-819 — temporally a 1-kernel)."""
    return t_conv(w)[None]


def stepvideo_map(heads: int = 48) -> ConversionMap:
    """StepVideoModel (modules/model.py:738-920) torch names → our
    StepVideoModel tree. Run :func:`preprocess_split_headwise` on
    ``attn1.wqkv`` → (wq, wk, wv) and ``attn2.wkv`` → (wk, wv) first."""
    dg = t_dense_general(heads)
    blk = r"transformer_blocks\.(\d+)\."
    return ConversionMap([
        (r"pos_embed\.proj\.weight", r"patch_embed/kernel",
         _t_conv2d_to_patch3d),
        (r"pos_embed\.proj\.bias", r"patch_embed/bias", None),
        (r"adaln_single\.emb\.timestep_embedder\.linear_1\.weight",
         r"t_embedder/fc1/kernel", t_linear),
        (r"adaln_single\.emb\.timestep_embedder\.linear_1\.bias",
         r"t_embedder/fc1/bias", None),
        (r"adaln_single\.emb\.timestep_embedder\.linear_2\.weight",
         r"t_embedder/fc2/kernel", t_linear),
        (r"adaln_single\.emb\.timestep_embedder\.linear_2\.bias",
         r"t_embedder/fc2/bias", None),
        (r"adaln_single\.linear\.weight", r"t_block/kernel", t_linear),
        (r"adaln_single\.linear\.bias", r"t_block/bias", None),
        (r"caption_projection\.linear_1\.weight", r"caption_fc1/kernel",
         t_linear),
        (r"caption_projection\.linear_1\.bias", r"caption_fc1/bias", None),
        (r"caption_projection\.linear_2\.weight", r"caption_fc2/kernel",
         t_linear),
        (r"caption_projection\.linear_2\.bias", r"caption_fc2/bias", None),
        (r"clip_projection\.weight", r"clip_proj/kernel", t_linear),
        (r"clip_projection\.bias", r"clip_proj/bias", None),
        (rf"{blk}norm1\.weight", r"block_\1/norm1/scale", None),
        (rf"{blk}norm1\.bias", r"block_\1/norm1/bias", None),
        (rf"{blk}norm2\.weight", r"block_\1/norm2/scale", None),
        (rf"{blk}norm2\.bias", r"block_\1/norm2/bias", None),
        (rf"{blk}attn1\.wq\.weight", r"block_\1/self_q/kernel", dg),
        (rf"{blk}attn1\.wk\.weight", r"block_\1/self_k/kernel", dg),
        (rf"{blk}attn1\.wv\.weight", r"block_\1/self_v/kernel", dg),
        (rf"{blk}attn1\.wo\.weight", r"block_\1/self_out/kernel",
         t_linear),
        (rf"{blk}attn1\.q_norm\.weight", r"block_\1/q_norm/scale", None),
        (rf"{blk}attn1\.k_norm\.weight", r"block_\1/k_norm/scale", None),
        (rf"{blk}attn2\.wq\.weight", r"block_\1/cross_q/kernel", dg),
        (rf"{blk}attn2\.wk\.weight", r"block_\1/cross_k/kernel", dg),
        (rf"{blk}attn2\.wv\.weight", r"block_\1/cross_v/kernel", dg),
        (rf"{blk}attn2\.wo\.weight", r"block_\1/cross_out/kernel",
         t_linear),
        (rf"{blk}attn2\.q_norm\.weight", r"block_\1/cross_q_norm/scale",
         None),
        (rf"{blk}attn2\.k_norm\.weight", r"block_\1/cross_k_norm/scale",
         None),
        (rf"{blk}ff\.net\.0\.proj\.weight", r"block_\1/ffn1/kernel",
         t_linear),
        (rf"{blk}ff\.net\.2\.weight", r"block_\1/ffn2/kernel", t_linear),
        (rf"{blk}scale_shift_table", r"block_\1/scale_shift_table",
         _identity),
        (r"^scale_shift_table$", r"final_scale_shift_table", _identity),
        (r"proj_out\.weight", r"final_proj/kernel", t_linear),
        (r"proj_out\.bias", r"final_proj/bias", None),
    ])


def _patch_conv2d_to_dense(w: np.ndarray) -> np.ndarray:
    """Patch-embed Conv2d (out, in, kh, kw) with stride == kernel → Dense
    kernel over tokens flattened (kh, kw, in) → out."""
    out = w.shape[0]
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0).reshape(-1, out))


def mochi_map(heads: int = 24) -> ConversionMap:
    """diffusers ``MochiTransformer3DModel`` names (genmo/mochi-1-preview,
    the backbone of diffusers' MochiPipeline) → the ``MochiDiT`` tree. The last transformer block has no
    to_add_out/ff_context/norm1_context gates (update_y=False) — its
    norm1_context.linear maps onto the scale-only ``mod_y``."""
    dg = t_dense_general(heads)
    blk = r"transformer_blocks\.(\d+)\."
    return ConversionMap([
        (r"patch_embed\.proj\.weight", r"patch_embed/kernel",
         _patch_conv2d_to_dense),
        (r"patch_embed\.proj\.bias", r"patch_embed/bias", None),
        (r"time_embed\.timestep_embedder\.linear_1\.weight",
         r"t_embedder/fc1/kernel", t_linear),
        (r"time_embed\.timestep_embedder\.linear_1\.bias",
         r"t_embedder/fc1/bias", None),
        (r"time_embed\.timestep_embedder\.linear_2\.weight",
         r"t_embedder/fc2/kernel", t_linear),
        (r"time_embed\.timestep_embedder\.linear_2\.bias",
         r"t_embedder/fc2/bias", None),
        (r"time_embed\.pooler\.to_kv\.weight", r"t5_pool/to_kv/kernel",
         t_linear),
        (r"time_embed\.pooler\.to_kv\.bias", r"t5_pool/to_kv/bias", None),
        (r"time_embed\.pooler\.to_q\.weight", r"t5_pool/to_q/kernel",
         t_linear),
        (r"time_embed\.pooler\.to_q\.bias", r"t5_pool/to_q/bias", None),
        (r"time_embed\.pooler\.to_out\.weight", r"t5_pool/to_out/kernel",
         t_linear),
        (r"time_embed\.pooler\.to_out\.bias", r"t5_pool/to_out/bias", None),
        (r"time_embed\.caption_proj\.weight", r"caption_proj/kernel",
         t_linear),
        (r"time_embed\.caption_proj\.bias", r"caption_proj/bias", None),
        (r"pos_frequencies", r"pos_frequencies", _identity),
        (blk + r"norm1\.linear\.weight", r"block_\1/mod_x/kernel",
         t_linear),
        (blk + r"norm1\.linear\.bias", r"block_\1/mod_x/bias", None),
        (blk + r"norm1_context\.linear\.weight", r"block_\1/mod_y/kernel",
         t_linear),
        (blk + r"norm1_context\.linear\.bias", r"block_\1/mod_y/bias",
         None),
        (blk + r"attn1\.to_q\.weight", r"block_\1/q_x/kernel", dg),
        (blk + r"attn1\.to_k\.weight", r"block_\1/k_x/kernel", dg),
        (blk + r"attn1\.to_v\.weight", r"block_\1/v_x/kernel", dg),
        (blk + r"attn1\.norm_q\.weight", r"block_\1/norm_q_x/scale", None),
        (blk + r"attn1\.norm_k\.weight", r"block_\1/norm_k_x/scale", None),
        (blk + r"attn1\.add_q_proj\.weight", r"block_\1/q_y/kernel", dg),
        (blk + r"attn1\.add_k_proj\.weight", r"block_\1/k_y/kernel", dg),
        (blk + r"attn1\.add_v_proj\.weight", r"block_\1/v_y/kernel", dg),
        (blk + r"attn1\.norm_added_q\.weight", r"block_\1/norm_q_y/scale",
         None),
        (blk + r"attn1\.norm_added_k\.weight", r"block_\1/norm_k_y/scale",
         None),
        (blk + r"attn1\.to_out\.0\.weight", r"block_\1/proj_x/kernel",
         t_linear),
        (blk + r"attn1\.to_out\.0\.bias", r"block_\1/proj_x/bias", None),
        (blk + r"attn1\.to_add_out\.weight", r"block_\1/proj_y/kernel",
         t_linear),
        (blk + r"attn1\.to_add_out\.bias", r"block_\1/proj_y/bias", None),
        (blk + r"ff\.net\.0\.proj\.weight", r"block_\1/ff_x_in/kernel",
         t_linear),
        (blk + r"ff\.net\.2\.weight", r"block_\1/ff_x_out/kernel",
         t_linear),
        (blk + r"ff_context\.net\.0\.proj\.weight",
         r"block_\1/ff_y_in/kernel", t_linear),
        (blk + r"ff_context\.net\.2\.weight", r"block_\1/ff_y_out/kernel",
         t_linear),
        (r"norm_out\.linear\.weight", r"final_mod/kernel", t_linear),
        (r"norm_out\.linear\.bias", r"final_mod/bias", None),
        (r"proj_out\.weight", r"final_proj/kernel", t_linear),
        (r"proj_out\.bias", r"final_proj/bias", None),
    ])



# ---------------------------------------------------------------------------
# Maps of the families the port does not run yet: each raises, naming the
# ROADMAP.md item its target module waits for
# ---------------------------------------------------------------------------

def _waits(name: str, item: str):
    def waiting_map(*args, **kwargs) -> ConversionMap:
        raise NotImplementedError(
            f"{name}: its target module is not ported yet (ROADMAP.md "
            f"queue 1, {item})")
    waiting_map.__name__ = name
    return waiting_map


flux_map = _waits("flux_map", "item 8.5 (Flux)")
clip_vision_map = _waits("clip_vision_map",
                         "items 10.4 and 10.5 (models/clip_vision.py)")
aesthetic_map = _waits("aesthetic_map",
                       "items 10.4 and 10.5 (the aesthetic scorer)")
llava_projector_map = _waits("llava_projector_map",
                             "item 4 (HunyuanVideo i2v)")
