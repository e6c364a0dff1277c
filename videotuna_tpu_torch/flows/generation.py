"""GenerationFlow (torch): the model composition of the port, the counterpart
of ``videotuna_tpu/flows/generation.py``.  A flow is four components —

    first_stage   VAE (decode latents to pixels)
    cond_stage    text encoder
    denoiser      DiT
    scheduler     diffusion schedule

— instantiated from the same ``{target:, params:}`` YAML.  Where the JAX flow
keeps one params dict beside stateless modules and compiles one jit per
geometry, the port's weights live in its ``nn.Module``s and every call runs
eagerly on ``self.device``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from videotuna_tpu_torch.core.config import resolve_device, resolve_dtype
from videotuna_tpu_torch.core.monitor import save_metrics
from videotuna_tpu_torch.core.prng import KeyChain
from videotuna_tpu_torch.core.registry import instantiate
from videotuna_tpu_torch.data.video_io import save_video
from videotuna_tpu_torch.models.layers import init_weights_
from videotuna_tpu_torch.models.text_encoders import tokenize
from videotuna_tpu_torch.schedulers import cfg_denoise

Cond = Dict[str, torch.Tensor]

COMPONENT_NAMES = ("denoiser", "first_stage", "cond_stage")


def _build_module(config: Dict[str, Any], device: torch.device) -> nn.Module:
    """Instantiate a module without initialising it twice: built on the meta
    device, then given uninitialised storage on ``device``.  ``init_params``
    or ``tools.from_jax`` fills the weights."""
    with torch.device("meta"):
        module = instantiate(config)
    return module.to_empty(device=device).eval()


class GenerationFlow:
    """Base flow. Concrete subclasses bind shapes and the sampling recipe."""

    latent_channels: int = 4
    vae_spatial_ratio: int = 8
    vae_temporal_ratio: int = 1

    def __init__(self,
                 denoiser_config: Dict[str, Any],
                 scheduler_config: Dict[str, Any],
                 first_stage_config: Optional[Dict[str, Any]] = None,
                 cond_stage_config: Optional[Dict[str, Any]] = None,
                 cond_stage_2_config: Optional[Dict[str, Any]] = None,
                 scale_factor: float = 0.18215,
                 trainable_components: Sequence[str] = ("denoiser",),
                 tokenizer: Optional[str] = None,
                 model_max_length: int = 120,
                 param_dtype: Any = "float32",
                 attn_static_max: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if cond_stage_2_config:
            raise NotImplementedError(
                "a second conditioning stage (Hunyuan, StepVideo) is not "
                "ported yet")
        self.device = resolve_device(device)
        self.denoiser = _build_module(denoiser_config, self.device)
        self.scheduler = instantiate(scheduler_config).to(self.device)
        self.first_stage = (_build_module(first_stage_config, self.device)
                            if first_stage_config else None)
        self.cond_stage = (_build_module(cond_stage_config, self.device)
                           if cond_stage_config else None)
        self.scale_factor = scale_factor
        self.trainable_components = tuple(trainable_components)
        self.tokenizer = tokenizer
        self.model_max_length = model_max_length
        self.param_dtype = resolve_dtype(param_dtype)
        # Fixed softmax max (log2 domain) for the flash kernels — valid only
        # for qk-normed denoisers; applied around sampling, and only at
        # attention sites that declare bounded logits.
        self.attn_static_max = attn_static_max

    def _attn_scope(self):
        stack = contextlib.ExitStack()
        if self.attn_static_max is not None:
            from videotuna_tpu_torch.kernels.attention import \
                attention_options
            stack.enter_context(
                attention_options(static_max=float(self.attn_static_max)))
        return stack

    def components(self) -> Dict[str, nn.Module]:
        return {name: getattr(self, name) for name in COMPONENT_NAMES
                if getattr(self, name) is not None}

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights, one named generator stream per component,
        drawn on the flow's device."""
        keys = KeyChain(seed, self.device)
        for name, module in self.components().items():
            init_weights_(module, keys(f"init_{name}"))

    # ------------------------------------------------------------ components
    @torch.inference_mode()
    def encode_text(self, texts: Sequence[str]) -> Cond:
        """The conditioning dict {"y", "mask"}."""
        ids, mask = tokenize(texts, pretrained=self.tokenizer,
                             max_length=self.model_max_length)
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        return {"y": self.cond_stage(ids, mask), "mask": mask}

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        if self.first_stage is None:
            return z
        return self.first_stage.decode(z / self.scale_factor)

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        """Raw denoiser application; subclasses adapt the cond signature."""
        raise NotImplementedError

    # -------------------------------------------------------------- sampling
    def latent_shape(self, batch: int, num_frames: int, height: int,
                     width: int) -> Tuple[int, ...]:
        return (batch,
                (num_frames - 1) // self.vae_temporal_ratio + 1
                if self.vae_temporal_ratio > 1 else num_frames,
                height // self.vae_spatial_ratio,
                width // self.vae_spatial_ratio,
                self.latent_channels)

    @torch.inference_mode()
    def sample(self, cond: Cond, uncond: Optional[Cond], shape,
               generator: torch.Generator, cfg_scale: float = 7.5,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latent sampling under the flow's scheduler; ``x_T`` and
        ``noises`` replace the generator's draws."""
        denoise = cfg_denoise(self.denoise_apply, cond, uncond, cfg_scale)
        return self._run_sampler(denoise, shape, generator, x_T, noises)

    def _run_sampler(self, denoise, shape, generator, x_T, noises):
        # only the stochastic samplers take per-step noise
        kw = {} if noises is None else {"noises": noises}
        with self._attn_scope():
            return self.scheduler.sample(denoise, shape, generator, x_T=x_T,
                                         **kw)

    # ------------------------------------------------------------- inference
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def inference(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Prompts → videos → mp4s (or .npy without a codec) + metric.json.

        ``inference.decode_latent_frames`` (port only) decodes just the
        first n latent frames, for a run whose full-length decode does not
        fit in device memory."""
        inf = config.get("inference", config)
        if inf.get("input_dir") or inf.get("image_dir"):
            raise NotImplementedError(
                "image-conditioned (i2v) inference is not ported yet")
        if inf.get("vbench_format", inf.get("standard_vbench", False)):
            raise NotImplementedError(
                "VBench-format output waits for the evalkit slice")
        savedir = inf.get("savedir", "results/run")
        prompts = load_prompts(inf)
        bs = int(inf.get("bs", 1))
        n_samples = int(inf.get("n_samples_prompt", 1))
        height = int(inf.get("height", 256))
        width = int(inf.get("width", 256))
        frames = int(inf.get("frames", inf.get("num_frames", 16)))
        cfg_scale = float(inf.get("unconditional_guidance_scale",
                                  inf.get("cfg_scale", 7.5)))
        fps = int(inf.get("fps", 8))
        keys = KeyChain(int(inf.get("seed", 42)), self.device)
        decode_frames = inf.get("decode_latent_frames")
        os.makedirs(savedir, exist_ok=True)

        results = []
        per_prompt: Dict[str, float] = {}
        sample_sec = decode_sec = 0.0
        nonfinite_latents = nonfinite_pixels = 0
        t_start = time.perf_counter()
        # negative prompt encoded once and tiled per chunk
        neg = str(inf.get("negative_prompt", ""))
        uncond1 = self.encode_text([neg]) if cfg_scale != 1.0 else None
        for i in range(0, len(prompts), bs):
            chunk = prompts[i:i + bs]
            t_p = time.perf_counter()
            cond = self.encode_text(chunk)
            uncond = None
            if uncond1 is not None:
                uncond = {k: v.repeat_interleave(len(chunk), dim=0)
                          for k, v in uncond1.items()}
            for s in range(n_samples):
                shape = self.latent_shape(len(chunk), frames, height, width)
                self._sync()
                t0 = time.perf_counter()
                z = self.sample(cond, uncond, shape, keys("sample"),
                                cfg_scale)
                self._sync()
                t1 = time.perf_counter()
                nonfinite_latents += int((~torch.isfinite(z)).sum())
                if decode_frames:
                    z = z[:, :int(decode_frames)]
                videos = self.decode_latents(z).float().cpu().numpy()
                t2 = time.perf_counter()
                nonfinite_pixels += int((~np.isfinite(videos)).sum())
                sample_sec += t1 - t0
                decode_sec += t2 - t1
                for j, prompt in enumerate(chunk):
                    name = savename(prompt, i + j, s)
                    results.append(save_video(
                        videos[j], os.path.join(savedir, name), fps=fps))
            for prompt in chunk:
                per_prompt[prompt] = round(
                    (time.perf_counter() - t_p) / len(chunk), 3)
        metrics = {"time_sec": round(time.perf_counter() - t_start, 3),
                   "num_videos": len(results),
                   "per_prompt_sec": per_prompt,
                   "sample_sec": sample_sec,
                   "decode_sec": decode_sec,
                   "denoise_steps": self.scheduler.num_steps,
                   "nonfinite_latents": nonfinite_latents,
                   "nonfinite_pixels": nonfinite_pixels,
                   "device": str(self.device)}
        save_metrics(metrics, savedir, config)
        return {"videos": results, "metrics": metrics}


def load_prompts(inf_config: Dict[str, Any]) -> list[str]:
    """Prompt-file or inline prompt loading."""
    if inf_config.get("prompts_list"):
        return list(inf_config["prompts_list"])
    if "prompt" in inf_config and inf_config["prompt"]:
        return [str(inf_config["prompt"])]
    pf = inf_config.get("prompt_file") or inf_config.get("prompt_dir")
    if pf:
        if not os.path.isfile(pf):
            raise FileNotFoundError(f"prompt file not found: {pf}")
        with open(pf) as f:
            return [l.strip() for l in f if l.strip()]
    return ["a beautiful coastal beach in spring, waves lapping on sand"]


def savename(prompt: str, idx: int, sample_idx: int,
             max_words: int = 10) -> str:
    """Truncated prompt words + indices."""
    words = "".join(c if c.isalnum() or c == " " else ""
                    for c in prompt).split()[:max_words]
    stem = "-".join(words) if words else "sample"
    return f"{idx:04d}-{stem}-{sample_idx}.mp4"
