"""GenerationFlow (torch): the model composition of the port, the counterpart
of ``videotuna_tpu/flows/generation.py``.  A flow is four components —

    first_stage   VAE (decode latents to pixels)
    cond_stage    text encoder [+ optional cond_stage_2]
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

from videotuna_tpu_torch.core import checkpoint as ckpt_lib
from videotuna_tpu_torch.core.config import resolve_device, resolve_dtype
from videotuna_tpu_torch.core.monitor import save_metrics
from videotuna_tpu_torch.core.prng import KeyChain
from videotuna_tpu_torch.core.registry import instantiate
from videotuna_tpu_torch.data.transforms import CenterCropResize, Normalize
from videotuna_tpu_torch.data.video_io import save_video
from videotuna_tpu_torch.models.layers import init_weights_
from videotuna_tpu_torch.models.text_encoders import tokenize
from videotuna_tpu_torch.models.vae2d import DiagonalGaussian
from videotuna_tpu_torch.schedulers import cfg_denoise
from videotuna_tpu_torch.schedulers.common import randn

Cond = Dict[str, torch.Tensor]

COMPONENT_NAMES = ("denoiser", "first_stage", "cond_stage", "cond_stage_2")


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
    i2v_mode: bool = False      # a flow that samples from an image

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
        self.device = resolve_device(device)
        self.denoiser = _build_module(denoiser_config, self.device)
        self.scheduler = instantiate(scheduler_config).to(self.device)
        self.first_stage = (_build_module(first_stage_config, self.device)
                            if first_stage_config else None)
        self.cond_stage = (_build_module(cond_stage_config, self.device)
                           if cond_stage_config else None)
        self.cond_stage_2 = (_build_module(cond_stage_2_config, self.device)
                             if cond_stage_2_config else None)
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

    # ----------------------------------------------------------- checkpoints
    def save_pretrained(self, path: str, step: int = 0,
                        only_trained: bool = False) -> str:
        """Each component's ``state_dict`` (only the trainable ones with
        ``only_trained``) as ``path/step_<step>/<component>.pt``; returns
        the step dir."""
        comps = {name: module.state_dict()
                 for name, module in self.components().items()
                 if not only_trained or name in self.trainable_components}
        return ckpt_lib.save_components(path, step, comps)

    def from_pretrained(self, path: str) -> "GenerationFlow":
        """Load the components saved under ``path``, a step dir or a root
        whose newest ``step_<n>`` dir is taken (as
        ``ckpt_tools convert`` and ``save_pretrained`` write them), each
        strictly into its module; a component without a file keeps its
        weights.  A JAX (orbax) step dir cannot be read: orbax needs
        JAX."""
        def holds(d):
            return any(os.path.isfile(os.path.join(d, f"{c}.pt"))
                       for c in COMPONENT_NAMES)

        step_dir = path
        if not holds(path):
            step_dir = ckpt_lib.latest_step_dir(path)
            if step_dir is None or not holds(step_dir):
                if any(os.path.isdir(os.path.join(d, c))
                       for d in {path, step_dir or path}
                       for c in COMPONENT_NAMES):
                    raise NotImplementedError(
                        f"{path} holds an orbax checkpoint of the JAX "
                        "package; convert the upstream checkpoint with "
                        "videotuna_tpu_torch.tools.ckpt_tools instead")
                raise FileNotFoundError(f"No checkpoint under {path}")
        comps = self.components()
        restored = ckpt_lib.restore_components(step_dir, comps,
                                               map_location=self.device)
        for name, state in restored.items():
            comps[name].load_state_dict(state)
        return self

    # ------------------------------------------------------------ components
    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> Cond:
        """The conditioning dict {"y", "mask"}.  Under ``no_grad``, not
        ``inference_mode``: training feeds these states to a denoiser that
        autograd records, which refuses inference tensors."""
        ids, mask = tokenize(texts, pretrained=self.tokenizer,
                             max_length=self.model_max_length)
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        return {"y": self.cond_stage(ids, mask), "mask": mask}

    @torch.no_grad()
    def encode_video(self, video: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixels (B, T, H, W, 3) in [−1, 1] → a scaled latent sample of the
        frozen VAE's posterior, mean + std·noise.  ``noise`` (the latent's
        shape) replaces the draw from ``generator``."""
        moments = self.first_stage.encode(video.to(self.device))
        post = DiagonalGaussian(moments)
        if noise is None:
            return post.sample(generator) * self.scale_factor
        return (post.mean + post.std * noise.to(post.mean)) \
            * self.scale_factor

    def _draw_t_noise(self, z: torch.Tensor,
                      generator: Optional[torch.Generator],
                      t: Optional[torch.Tensor],
                      noise: Optional[torch.Tensor]):
        """Training timesteps (B,) uniform over the base chain and the
        q_sample noise; given values replace the draws."""
        if t is None:
            if generator is None:
                raise ValueError("drawing t needs a torch.Generator")
            t = torch.randint(0, self.base_schedule.num_timesteps,
                              (z.shape[0],), generator=generator,
                              device=z.device)
        if noise is None:
            noise = randn(z.shape, generator, z.device)
        return t.to(z.device), noise.to(z)

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        if self.first_stage is None:
            return z
        return self.first_stage.decode(z / self.scale_factor)

    def denoise_apply(self, x: torch.Tensor, t: torch.Tensor,
                      cond: Cond) -> torch.Tensor:
        """Raw denoiser application; subclasses adapt the cond signature."""
        raise NotImplementedError

    def prepare_image_cond(self, cond: Cond, uncond: Optional[Cond],
                           images: torch.Tensor, frames: int, height: int,
                           width: int,
                           generator: Optional[torch.Generator] = None,
                           posterior_noise: Optional[torch.Tensor] = None
                           ) -> Tuple[Cond, Optional[Cond]]:
        """Attach image conditioning to (cond, uncond) for i2v inference;
        ``images``: (B, H, W, 3) in [−1, 1] at video resolution.  Flows
        with an i2v path override it; ``posterior_noise`` replaces the
        encode's draw from ``generator``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support image-conditioned "
            "(i2v) inference")

    # -------------------------------------------------------------- training
    def training_loss(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      posterior_noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, aux) of one batch.  ``t``, ``noise`` and
        ``posterior_noise`` replace the draws from ``generator``."""
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

    def kept_latents(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """The sampled latents that the decode keeps: all of them, unless a
        flow samples padded latents and drops the padding here."""
        return z

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

        ``inference.input_dir`` (or ``image_dir``) makes it image-to-video:
        the prompts and images of ``load_inputs_i2v``, through
        ``prepare_image_cond``.  ``inference.decode_latent_frames`` (port
        only) decodes just the first n kept latent frames, for a run whose
        full-length decode does not fit in device memory."""
        inf = config.get("inference", config)
        if inf.get("vbench_format", inf.get("standard_vbench", False)):
            raise NotImplementedError(
                "VBench-format output waits for the evalkit slice")
        savedir = inf.get("savedir", "results/run")
        height = int(inf.get("height", 256))
        width = int(inf.get("width", 256))
        # i2v: a directory of (image, prompt) pairs routes through
        # prepare_image_cond
        input_dir = inf.get("input_dir") or inf.get("image_dir")
        i2v_images = None
        if input_dir:
            _, i2v_images, prompts = load_inputs_i2v(input_dir,
                                                     (height, width))
        elif self.i2v_mode:
            raise ValueError(
                f"{type(self).__name__} in i2v_mode needs its images: set "
                "inference.input_dir=DIR (one .txt of prompts and the "
                "images, sorted by name); the configs' prompt_dir names no "
                "such directory (ROADMAP.md queue 3)")
        else:
            prompts = load_prompts(inf)
        bs = int(inf.get("bs", 1))
        n_samples = int(inf.get("n_samples_prompt", 1))
        frames = int(inf.get("frames", inf.get("num_frames", 16)))
        cfg_scale = float(inf.get("unconditional_guidance_scale",
                                  inf.get("cfg_scale", 7.5)))
        fps = int(inf.get("fps", 8))
        keys = KeyChain(int(inf.get("seed", 42)), self.device)
        decode_frames = inf.get("decode_latent_frames")
        os.makedirs(savedir, exist_ok=True)

        results = []
        per_prompt: Dict[str, float] = {}
        encode_sec = image_encode_sec = sample_sec = decode_sec = 0.0
        shape = kept_shape = None
        nonfinite_latents = nonfinite_pixels = 0
        t_start = time.perf_counter()
        # negative prompt encoded once and tiled per chunk
        neg = str(inf.get("negative_prompt", ""))
        uncond1 = self.encode_text([neg]) if cfg_scale != 1.0 else None
        for i in range(0, len(prompts), bs):
            chunk = prompts[i:i + bs]
            t_p = time.perf_counter()
            cond = self.encode_text(chunk)
            self._sync()
            encode_sec += time.perf_counter() - t_p
            uncond = None
            if uncond1 is not None:
                uncond = {k: v.repeat_interleave(len(chunk), dim=0)
                          for k, v in uncond1.items()}
            if i2v_images is not None:
                t_i = time.perf_counter()
                cond, uncond = self.prepare_image_cond(
                    cond, uncond, i2v_images[i:i + len(chunk)], frames,
                    height, width, keys("img_cond"))
                self._sync()
                image_encode_sec += time.perf_counter() - t_i
            for s in range(n_samples):
                shape = self.latent_shape(len(chunk), frames, height, width)
                self._sync()
                t0 = time.perf_counter()
                z = self.sample(cond, uncond, shape, keys("sample"),
                                cfg_scale)
                self._sync()
                t1 = time.perf_counter()
                z = self.kept_latents(z, frames)
                nonfinite_latents += int((~torch.isfinite(z)).sum())
                if decode_frames:
                    z = z[:, :int(decode_frames)]
                kept_shape = tuple(z.shape)
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
                   "encode_sec": encode_sec,
                   "image_encode_sec": image_encode_sec,
                   "sample_sec": sample_sec,
                   "decode_sec": decode_sec,
                   "denoise_steps": self.scheduler.num_steps,
                   # the sampled latents and the part of them decoded
                   "latent_shape": list(shape) if shape else None,
                   "decoded_latent_shape": (list(kept_shape) if kept_shape
                                            else None),
                   "nonfinite_latents": nonfinite_latents,
                   "nonfinite_pixels": nonfinite_pixels,
                   "device": str(self.device)}
        save_metrics(metrics, savedir, config)
        return {"videos": results, "metrics": metrics}


def load_inputs_i2v(input_dir: str, video_size: Tuple[int, int]
                    ) -> Tuple[list, torch.Tensor, list]:
    """(names, images, prompts) of an i2v input directory: ONE .txt of
    prompts (the first by name), the images sorted by name and paired by
    index, each resized on its short side and center-cropped to
    ``video_size`` (H, W), in [−1, 1].  Images are f32 (N, H, W, 3) on the
    CPU."""
    import cv2

    files = sorted(os.listdir(input_dir))
    txts = [f for f in files if f.endswith(".txt")]
    if not txts:
        raise ValueError(f"found NO prompt .txt in {input_dir}")
    with open(os.path.join(input_dir, txts[0])) as f:
        prompts = [line.strip() for line in f if line.strip()]
    img_files = [f for f in files if f.lower().endswith(
        (".png", ".jpg", ".jpeg", ".webp"))]
    if len(img_files) < len(prompts):
        raise ValueError(f"{len(prompts)} prompts but only "
                         f"{len(img_files)} images in {input_dir}")
    crop, norm = CenterCropResize(video_size), Normalize()
    images, names = [], []
    for fname in img_files[:len(prompts)]:
        img = cv2.imread(os.path.join(input_dir, fname))
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        images.append(norm(crop(img[None]))[0])
        names.append(os.path.splitext(fname)[0])
    return names, torch.from_numpy(np.stack(images)), prompts


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
