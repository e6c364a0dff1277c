"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hunyuan-train FRAMES
    python3 chip_smoke.py --wan
    python3 chip_smoke.py --cogvideox
    python3 chip_smoke.py --videocrafter
    python3 chip_smoke.py --vc-train [kernels|train]
    python3 chip_smoke.py --stepvideo
    python3 chip_smoke.py --mochi
    python3 chip_smoke.py --flux
    python3 chip_smoke.py --v2v
    python3 chip_smoke.py --hunyuan-i2v
    python3 chip_smoke.py --opensora12 [STEPS]
    python3 chip_smoke.py --serve
    python3 chip_smoke.py --parallel

The second form builds the kernels and runs only the HunyuanVideo LoRA
training (phase 21) at FRAMES×720×1280, without the resume, and prints its
peak memory and seconds per step as a JSON line: the frame cut of phase 21
is chosen from such runs.  The third runs only the Wan 2.1 phases (23–27)
and prints their figures as a JSON line.  The fourth runs only the
CogVideoX I2V and 1.5 phases (28–33) and prints their figures as a JSON
line before the result line.  The fifth runs only the VideoCrafter,
DynamiCrafter and Wan I2V phases (34–40), likewise.  The sixth runs only
the VideoCrafter2 training phases (41–44; "kernels": 41 and 42, "train":
43 and 44), likewise.  The seventh and the eighth run only phase 45 and
the StepVideo phases (46, 47, 49) or the Mochi ones (48, 50), likewise;
the ninth and the tenth the Flux phases (51–54) or the V2V ones (55–57),
likewise; the eleventh the HunyuanVideo I2V phases (58–61) and the
twelfth the Open-Sora 1.2 ones (62–64, all 30 steps unless STEPS says),
likewise; the thirteenth the serving phases (66–68), likewise; the
fourteenth the parallel phases (69–72), likewise.

Phases, each printing its own lines; any failure raises and exits non-zero
without a result line:

1. device     — the card's name and power limit (nvidia-smi).
2. build      — compiles every CUDA kernel of the port from kernels/csrc,
                one nvcc per source, all started together.
3. K1, K6     — the d=64 route of flash_fwd (the persistent kernel of
                flash_fwd_sm90.cu at D=64) against its plain PyTorch
                version on the card, at the CogVideoX-5B shape (B=2 with
                CFG, S=17776, H=48, bf16) in both softmax modes with the
                LSE, and at ragged shapes (300 × 4322 and 17 × 4322 split
                their keys into ranges, counted as splits); K6 at its A/B
                shape (B=2, 300 × 4322, H=4) on the same kernel with its
                keys split into 5 ranges and the combine, online and under
                the fixed max with the LSE, the same bits twice, counted
                as K6 and as a split.  Times the kernel, its plain version
                and torch's scaled_dot_product_attention (SDPA, a
                yardstick only: the port never calls it), and, at K1's
                shape beside K1, the mma.sync kernel (flash_fwd.cu, the
                A/B baseline); K6 also by device time and host time,
                beside the unsplit walk on the same tensors (in turns),
                flash_fwd.cu and SDPA's device time.
4. K2         — the generic flash route against its plain version: the
                STDiT-XL/2 spatial shape (B=32, S=256, H=16, d=72, online)
                and d=72 1×64 on the Hopper kernel (flash_fwd_sm90.cu,
                persistent), d=64 causal 333×333, d=128 300×4322 and d=256
                200×200 with a fixed max on LayerNormed q, k on
                flash_fwd.cu; every case with the LSE.  Timed at the STDiT
                shape beside the old design (flash_fwd.cu) on the same
                tensors and SDPA, by CUDA events and by device time.  The
                f32 causal case of HunyuanVideo's LLaMA (B=1, 256 tokens,
                32 heads of d=128) on the f32 design (flash_fwd_f32_sm90.cu,
                split key ranges and the combine) against the f32 plain
                version with the LSE, the same bits twice, timed by
                events, device time and host time beside its bound, the
                old flash_fwd.cu on the same tensors (in turns) and SDPA.
5. K4         — the key-masked route (flash_fwd_sm90.cu's persistent
                kernel with the packed mask) at the STDiT-XL/2
                cross-attention shape (B=2, 4096 queries, 120 keys, H=16,
                d=72): row 0 keeps 13 keys (a prefix, then every 9th key),
                row 1 all 120, with the LSE, online and (strided) under the
                fixed max; a row with no valid key must give zeros and an
                LSE of -inf in both modes.  Timed on the prefix mask beside
                the old design (flash_fwd.cu) and SDPA with the boolean
                mask as the yardstick.
6. e2e        — ``run_inference`` on configs/004_cogvideox/cogvideo5b.yaml at
                full width (dim 3072, 42 layers, T5-XXL, CogVideoX VAE) with
                random weights from the seed, one prompt at 49×480×720.
                Cut: 3 denoising steps (first-order, 2M and final step: every
                branch of the DPM step), and the VAE decodes the first 4
                latent frames (13 video frames) because the full-length f32
                decode does not fit beside the weights.  Asserts 42×3 = 126
                K1 launches, finite latents and pixels, the video's shape and
                metric.json, and every K1 on flash_fwd_sm90 with no
                alignment copy and unsplit.
7. reference  — the same flow at narrow width (2 layers, 2 heads of d=64)
                on the card and on the CPU with the same weights and noise:
                one denoiser call, the latents, and the VAE's decode of
                the same latents must agree.
8. e2e-opensora — ``run_inference`` on
                configs/003_opensora/opensorav10_256x256.yaml at full width
                and depth (STDiT-XL/2: hidden 1152, 28 layers, 16 heads of
                d=72, bf16; T5-XXL; the 2D VAE at ch 128), random weights
                from the seed, one prompt, 16×256×256, CFG 7, all 50 DDIM
                steps, the whole 16-frame decode.  Asserts 28×50 K2 and K4
                launches, every K2 and K4 on flash_fwd_sm90 with no
                alignment copy, and no K1 launch, finite latents and pixels, a
                (16, 256, 256, 3) video and metric.json.
9. reference-opensora — that flow at narrow width (hidden 144, 2 heads of
                d=72, depth 2, a narrow T5, the VAE at ch 32) on the card and
                on the CPU, same weights, x_T and prompt, TF32 off, 4×32×32
                latents, so that K2 (256 spatial tokens) and K4 (1024 cross
                queries) are on the path: one denoiser call, the latents
                after 5 steps and the decode must agree.  The VAE's mid
                attention (f32, one head of d=128 over 32×32 tokens) takes
                flash_fwd's f32 path on the card.
10. profile-opensora — one full-size STDiT-XL/2 denoiser call (CFG batch
                2) timed with CUDA events and traced with torch.profiler:
                device time by kernel group and the busy share.
11. bwd       — the flash backward against its plain version: K7 and
                K10 (single_pass=False) on flash_bwd_sm90.cu at the
                CogVideoX-2B training shape (B=1, S=17776, H=30, d=64) on
                the LSE of K1 under the fixed max and online (K1 itself
                timed there with the LSE, beside flash_fwd.cu and SDPA), the
                plain version 256 query rows at a time, timed beside the old
                two-pass flash_bwd.cu (``_flash_bwd_mma``) on the same
                tensors, which K7 must beat; K8 and K9 on
                flash_bwd_rows_sm90.cu at the STDiT-XL/2 spatial shape
                (B=16, S=256, H=16, d=72) and K8 at the cross shape (4096
                queries over 120 keys with a ragged mask, and a batch row
                with no valid key: zeros); K8 on flash_bwd_sm90 at d=128
                300×4322; K8 on flash_bwd.cu at d=128 masked 300×4322,
                d=64 causal 333×333, d=32
                causal at a ragged edge, d=256 and d=160 (B=2, S=300, H=3)
                causal and masked;
                the custom VJPs' gradients against autograd of the plain
                math.  K8 timed at both STDiT shapes (the cross case with
                13 of 120 keys and its own bound) beside the old design,
                by CUDA events, device time and host time, which it must
                beat by device time.  K5 (flash_fwd with the LSE, on
                flash_fwd_sm90.cu) at the spatial shape, beside the old
                design and SDPA as K2.  Times beside the bound, the plain
                version and SDPA's backward (fwd+bwd minus fwd, backend
                named, by events and by device time; a yardstick the port
                never calls).  HunyuanVideo's training attention (B=1, the
                LoRA run's 7,456 tokens, H=24, d=128, RMSNormed q and k):
                K5 under the fixed max 0 with the LSE on K3's Hopper kernel
                and K8 unmasked on flash_bwd_sm90 at its width 128, against
                the plain chunked versions (the old flash_bwd.cu too),
                timed beside the bound, the plain version, SDPA's forward
                and backward and the old designs (flash_fwd.cu,
                flash_bwd.cu) on the same tensors.
12. f32       — flash_fwd with f32 inputs against the f32 plain version at
                the narrow VAE's mid-attention shape (d=128: the f32
                design) and a ragged causal d=72 shape (flash_fwd.cu).
13. train-cog — the training CLI's trainer on
                configs/004_cogvideox/cogvideo2b_lora.yaml at full width and
                depth (dim 1920, 30 layers, 30 heads of d=64, T5-XXL, the
                CogVideoX VAE; LoRA rank 128 on every projection; remat), 3
                steps on dummy video at 49×480×720 (17,776 tokens), cut to
                13 frames only when the f32 VAE encode of 49 does not fit
                (the cut and the peak memory at the encode are printed).
                Asserts K1 = 60 and K7 = 30 per step, every K1 launch on
                flash_fwd_sm90 and every K7 on flash_bwd_sm90, finite
                losses and gradient norms, the LoRA moved, the step-3
                checkpoint and a --resume run that restores step 3.
14. train-stdit — the same on configs/003_opensora/opensorav10_256x256.yaml
                (STDiT-XL/2 full fine-tune, EMA 0.9999, 16×256×256):
                K5 = K4 = 28 and K8 = 56 per step, every K5 and K4 on
                flash_fwd_sm90 and every K8 on flash_bwd_rows_sm90, and the
                EMA moved.
15. train-reference — one training step of each flow at narrow width on the
                card and on the CPU with the same weights, batch, t (σ for
                HunyuanVideo), noise and LoRA tree: loss and trainable
                gradients must agree, and every card launch must be on a
                Hopper design.  HunyuanVideo at d=128 (dim 256, 1 double
                and 2 single blocks, 192 image + 160 text tokens, so K5 and
                K8 run on the card, on the Hopper designs at d=128).
16. K3        — the fixed-max route at d ≤ 128 (``flash_attention`` with
                static_max, launching flash_fwd_sm90 counted as K3) against
                its plain version at the HunyuanVideo 13B joint-attention
                shape (B=1, S=119,056 = 118,800 video + 256 text tokens, a
                16-key tail, H=24, d=128; the plain version 128 query rows
                at a time) and at B=2, S=4096, with no alignment copy;
                timed at the full shape beside its bound, the plain
                version, SDPA and the old flash_fwd on the same tensors
                (which it must beat).
17. e2e-hunyuan — ``run_inference`` on
                configs/007_hunyuanvideo/hunyuanvideo_t2v.yaml at full width
                and depth (dim 3072, 20 double and 40 single blocks, 24
                heads of d=128, bf16; LLaMA 4096×32 and CLIP-L in f32;
                HunyuanVAE), random weights from the seed, one prompt at
                129×720×1280.  Cut: 1 of the 50 Euler steps, and the VAE
                decodes the first 2 latent frames (5 pixel frames): the f32
                decode of all 33 does not fit.  Asserts K3 = 60 per step,
                all on flash_fwd_sm90 with no alignment copy, K2 = 32 (the
                f32 LLaMA encode), every one on the f32 design and split,
                none on flash_fwd.cu, and no other launch, finite
                latents and pixels, a (5, 720, 1280, 3) video and
                metric.json; logs seconds per step, the text encode, the
                decode and the peak memory.
18. reference-hunyuan — that flow at narrow width (dim 256, 2 heads of
                d=128, 1 double and 2 single blocks, a 2-layer LLaMA of
                d=128 over 160 tokens, the VAE at (32, 32, 64, 64)) on the
                card and on the CPU, same weights, prompt and x_T, TF32
                off: one denoiser call, the latents after 2 steps and the
                decode must agree, with K3 and K2 launched on the card.
19. profile-hunyuan — one full-width DiT call (the work of one step)
                timed with CUDA events and traced with torch.profiler:
                device time of K3, the GEMMs and the rest, the busy share.
20. device    — device time per call (50 calls captured in a CUDA graph,
                the replay timed) of K2, K5 and K4 (without and with the
                LSE) on flash_fwd_sm90, of the old flash_fwd.cu and of
                SDPA at STDiT's shapes, and of K8 on flash_bwd_rows_sm90
                beside the old flash_bwd.cu at both training shapes: at
                0.01–0.2 ms a kernel the host's launch (host_ms in the
                compare= lines) can set a loop's CUDA-event time.
21. train-hunyuan — HunyuanVideo T2V LoRA through the registry's command
                ``train-hunyuan-t2v-lora`` (cli/commands.py), on one card
                (train.mesh.fsdp=1, train.mesh.sp=1), remat on: full width
                and depth (dim 3072, 20 double and 40 single blocks, 24
                heads of d=128; LoRA rank 64; LLaMA and CLIP in f32), 3
                steps on dummy video at 720×1280 cut to 5 frames (2
                latent frames, 7,456 tokens: at 9 frames the f32 VAE encode
                runs out of memory beside the weights), then --resume.
                Asserts K5 = 120, K8 = 60 and K2 = 32 per step and no other
                launch, every K5 and K8 on the Hopper designs at d=128
                (K3's kernel with the LSE, flash_bwd_sm90) and every K2 on
                the split f32 design, finite losses, the LoRA moved, lora.pt and
                state.pt, step 3 restored; logs the peak memory, the tokens
                per attention and the step taken apart.
22. kernels   — status of every TPU kernel of the JAX package.
23. K3-wan    — K3 (``flash_attention`` under the fixed max 0, K3's Hopper
                kernel at d=128, in place) at Wan 2.1's shapes, B=2 under
                CFG, q and k RMSNormed over the full width: the 14B
                self-attention (75,600 tokens, H=40), the 1.3B
                self-attention (32,760, H=12) and the 14B text
                cross-attention (75,600 queries over 512 keys, H=40, four
                key tiles a query tile), each against its plain version
                (a block of query rows at a time) and timed beside its
                bound, the plain version and SDPA (device time too for a
                call under 0.2 ms).
24. e2e-wan14b — Wan 2.1 T2V 14B through the registry's
                ``inference-wanvideo-t2v-720p`` at full width and depth
                (dim 5120, 40 layers, 40 heads of d=128, bf16; T5-XXL in
                f32 over 512 tokens; the Wan VAE in f32), random weights
                from the seed, one prompt at 81×720×1280 with CFG 5 and the
                default negative prompt.  Cut: 1 of the 50 UniPC steps;
                all 21 latent frames decoded by the streamed decode (one
                latent frame a chunk).  Asserts K3 = 80 a step (40 self-
                and 40 cross-attention launches at B=2), all on K3's
                Hopper kernel in place, no other launch and no split,
                finite latents and pixels, an (81, 720, 1280, 3) video and
                metric.json; logs seconds per step, the text encode, the
                decode and the peak memory.
25. reference-wan — the 1.3B flow at narrow width (dim 256, 2 heads of
                d=128, 2 layers, a 2-layer T5 over 512 tokens, the VAE at
                dim 16) on the card and on the CPU, same weights, prompt,
                negative prompt and x_T, TF32 off: one denoiser call, the
                latents after 3 UniPC steps with CFG 5 and the streamed
                decode must agree, with K3 launched on the card for the
                self- (192 × 192) and the cross-attention (192 × 512).
26. profile-wan14b — one full-width 14B DiT call at B=2 (the work of one
                step) timed with CUDA events and traced with
                torch.profiler: device time of K3, the GEMMs and the rest,
                the busy share.
27. e2e-wan1.3b — Wan 2.1 T2V 1.3B through the registry's
                ``inference-wanvideo-t2v-1-3B`` at full width and depth:
                dim 1536, 30 layers, 12 heads of d=128, 81×480×832 (32,760
                tokens), 10 of the 50 UniPC steps with CFG 5, all 81
                frames decoded.  Asserts K3 = 60 a step on K3's Hopper
                kernel, no other launch, an (81, 480, 832, 3) video and
                finite values.
28. K1-cog15  — K1 (the persistent kernel of flash_fwd_sm90.cu at D=64,
                fixed max 0, as the main path runs it) at CogVideoX 1.5's
                joint attention: B=2 under CFG, 9,674 = 224 text + 7×30×45
                video tokens (a last query tile of 74 rows and a 74-key
                tail), H=48, LayerNormed q and k, against its plain version
                (a block of query rows at a time), unsplit, in place; timed
                by CUDA events and device time beside its bound, the plain
                version and SDPA.
29. e2e-cog15-t2v — CogVideoX 1.5 5B T2V through the registry's
                ``inference-cogvideox-15-5b-t2v`` at full width and depth
                (dim 3072, 42 layers, 48 heads of d=64, the (2, 2, 2)
                patch, 224 text tokens; T5-XXL; the CogVideoX VAE), random
                weights from the seed, one prompt at 49×480×720: 13 latent
                frames and one sampled in front for the temporal patch (14,
                9,674 tokens), the front one dropped before the decode.
                Cut as phase 6: 3 of 50 steps, the first 4 kept latent
                frames decoded.  Asserts K1 = 42 a step on flash_fwd_sm90,
                unsplit, no other launch, the sampled (14) and decoded (4
                of 13) latent shapes, finite latents and pixels, a (13,
                480, 720, 3) video and metric.json; logs seconds per step,
                the text and image encodes, the decode and the peak memory.
30. e2e-cog15-i2v — the same through ``inference-cogvideox-15-5b-i2v``
                (32 input channels), with ``inference.input_dir`` a
                directory of one seeded 480×720 PNG and a one-line
                prompts.txt: the image's latent, zero-padded over latent
                time, its front frame repeated, on the channels.
31. e2e-cog-i2v — CogVideoX-5B I2V through
                ``inference-cogvideo-i2v-diffusers`` (cogvideo5b_i2v.yaml,
                the cosine dynamic CFG), the same image, 13 latent frames,
                17,776 tokens; cut and asserts as phase 29.
32. reference-cog15 — the 1.5 I2V flow at narrow width (dim 128, 2 heads
                of d=64, 2 layers, the (2, 2, 2) patch, 32 input channels,
                a 2-layer T5 over 224 tokens, the VAE at ch 32) on the card
                and on the CPU, same weights, image, posterior noise, x_T
                and noise, TF32 off: 4 latent frames sampled at 9×96×128,
                320 tokens, so K1 runs on the card; the image latents, one
                denoiser call, the latents after 3 steps and the decode of
                the kept latents must agree.
33. profile-cog15 — one full-width CogVideoX 1.5 MMDiT call at B=2 (the
                work of one step, after an untraced warm-up call) timed
                with CUDA events and traced with torch.profiler: device
                time of K1, the GEMMs and the rest, the busy share.
34. K-vc      — the attention of the UNet3D paths as they call it, each
                against its plain version, counted per route and design,
                timed by CUDA events and device time beside its bound, the
                plain version and SDPA: K2 at d=64 with 5 heads (the UNet's
                first level, online, on the persistent kernel of
                flash_fwd_sm90.cu) at VideoCrafter2's 2,560 and
                DynamiCrafter's 9,216 tokens (B=32), self and over 77 text
                keys, each also beside the old design (flash_fwd.cu) on the
                same tensors, which it must not lose to at the self shapes;
                K1 online at the even-head levels (640 and 160 tokens, 2,304
                and 576, H=10 and 20), self and over 77 keys; DynamiCrafter's
                image cross-attention over its 16 resampler tokens (K2 at
                9,216, K1 at 2,304, 576 and 144 queries) and its middle
                block (K1, 144 tokens, H=20: self and over 77 keys); the CLIP image
                encoder's f32 K2 (B=1, 256 tokens, 16 heads of d=80, on
                flash_fwd.cu); K3 at Wan I2V's image cross-attention
                (75,600 queries over 256 CLIP tokens, B=2, H=40, d=128,
                the fixed max 0).
35. reference-vc — VideoCrafter2 and DynamiCrafter at narrow width (the
                UNet at 64 channels, 64-wide heads, one res block a level,
                f32; a 2-layer text CLIP; DynamiCrafter's image encoder at 2
                heads of d=80 over 256 tokens) on the card and on the CPU,
                same weights, image, posterior noise and x_T, TF32 off,
                4×128×256 frames: K2 (512 tokens) and K1 (128) run on the
                card (flash_fwd.cu's f32 path); DynamiCrafter's image tokens
                and latent, one UNet call, the latents after the DDIM steps
                and the decode must agree, the call within 1e-4 and the
                latents within 1e-3 (f32 limits: the sound runs read below
                1.2e-5, the UNet in bf16 above 2e-2); then the control:
                VideoCrafter2 again with every card attention output scaled
                by 1 + 1e-3, which must fail those limits.
36. e2e-vc2   — VideoCrafter2 T2V through ``inference-vc2-t2v-320x512``
                whole: UNet3D at 320 channels, channel_mult [1, 2, 4, 4],
                bf16, OpenCLIP-H text, 16×320×512, all 50 DDIM steps, CFG
                12, all 16 frames decoded.  Asserts K2 = 10 and K1 = 20 a
                step, all on flash_fwd_sm90 unsplit, no copy, no other
                launch, finite latents and pixels, the video and
                metric.json; logs seconds per step, the text encode, the
                decode and the peak memory.
37. e2e-dc    — DynamiCrafter I2V through ``inference-dc-i2v-576x1024``
                from one seeded 1024×576 PNG (``inference.input_dir``):
                16×576×1024, 10 of the 50 DDIM steps, CFG 7.5, every frame
                decoded; K2 = 15 and K1 = 33 a step (the image
                cross-attention, the middle at 144 tokens), the CLIP image
                encoder's 32 f32 K2 on flash_fwd.cu; logs the image
                conditioning's time too.
38. e2e-vc1   — ``inference-vc1-t2v-576x1024`` and
                ``inference-vc1-i2v-320x512`` at full width, 16 frames, cut
                to ddim_steps 3 (4 steps), every frame decoded.
39. profile-dc — one full-width DynamiCrafter UNet call at B=2·16 (after
                an untraced warm-up call), traced: device time of the flash
                kernels, GEMMs, convolutions, GroupNorm and the rest, the
                busy share.
40. e2e-wan-i2v — Wan 2.1 I2V-14B through ``inference-wanvideo-i2v-720p``
                with the layout its config lacks as overrides (i2v_mode,
                in_dim 36, cond_stage_2 the CLIP ViT-H/14 image embedder),
                from one seeded 1280×720 PNG: 81×720×1280, 1 of 50 steps,
                all frames by the streamed decode; K3 = 3·40 a step on K3's
                kernel, the CLIP encoder's 32 f32 K2 on flash_fwd.cu.
41. K-vct     — the attention of a VideoCrafter2 training step (B = 16
                frames, d = 64, bf16): K5 with the LSE at level 1's
                2,560² (5 heads) and over 77 text keys at 2,560, 640 and
                160 queries, K1 with the LSE at 640² and 160² (10 and 20
                heads), each one's backward on its output and LSE (K8 at 5
                heads, K7 at 10 and 20: flash_bwd_sm90, or over 77 keys
                flash_bwd_rows_sm90, with flash_bwd_sm90 beside it as the
                rule's A/B), against the plain versions (forward 2e-2 of
                max|o| and 1e-3 LSE, backward 2e-2 of max|grad|), counted
                per route, design and kernel; timed beside the bound, the
                plain version, SDPA and the old design (flash_fwd.cu,
                flash_bwd.cu).
42. train-reference-vc — one full fine-tune step of a narrow VideoCrafter2
                UNet (64 channels, two levels, bf16: 1 head at level 1, 2
                at level 2) on the card against the same weights as an f32
                UNet on the CPU, TF32 off: loss within 2e-2, every
                gradient within 3e-2 of its max or twice the CPU's own
                bf16 UNet's error on it, whichever is larger; every launch
                on the Hopper designs at d=64.
                Then its control: every card attention output scaled by
                1.05 must fail it.
43. train-vc2 — VideoCrafter2's full fine-tune through the registry's
                ``train-videocrafter-v2`` at full width and depth (UNet3D
                1.41B, f32 masters, AdamW, EMA), 16×320×512, batch 1, 3
                steps on dummy video: per step K5 = 20, K1 = 10, K8 = 10,
                K7 = 20, all on the Hopper designs at d = 64 (the 15
                backwards over 77 keys on flash_bwd_rows_sm90), seconds and
                peak memory, one more step taken apart; then
                ``save_pretrained`` of the trained UNet.
44. train-vc2-lora — ``train-videocrafter-lora`` (rank 16 on the config's
                targets) from ``flow.pretrained`` = phase 43's step dir,
                whose UNet it must hold exactly, 3 steps as phase 43.
45. K-step    — StepVideo's and Mochi's d=128 attention on K3's Hopper
                kernel at the sampling shapes (B=2, bf16): the self-
                attention with the online max (K2, 12,648², H=48), the
                cross-attention online with the key mask (K4, 12,648 × 77
                CLIP + 320 caption keys, H=48) and Mochi's joint attention
                under the fixed max 0 with the key mask (K4, 22,516²,
                H=24), each mask as all keys valid, a caption prefix, and
                the two batch rows padded apart, against the plain version
                (2e-2 of max|o|); timed beside flash_fwd.cu on the same
                tensors (in turns), the plain version, SDPA (with the
                boolean mask) and the bound of the kept keys; StepLLM's f32
                causal K2 at 320 tokens (48 heads) on the f32 design.
46. reference-step — StepVideo's DiT narrow (dim 256, 2 heads of d=128, 2
                layers) in bf16 on the card against f32 on the CPU, one
                call at B=2 over 256 tokens with a ragged caption (3e-2).
47. e2e-stepvideo — ``inference-stepvideo-t2v-544x992`` at 51×544×992
                (12,648 tokens), the DiT at full width and depth in bf16,
                with ``inference.mesh.tp=1``, 2 of 50 steps, StepLLM (f32)
                cut to 4 of 48 layers to fit one card; every self-attention
                on K2 and every cross-attention on K4 at d=128 on K3's
                kernel, every StepLLM attention on the f32 design.
48. reference-mochi — Mochi's DiT narrow (dim 256 / 64, 3 blocks) likewise
                over 128 video and 16 caption tokens (K4, fixed max 0).
49. dit-stepvideo-48 — one denoiser call of the 48-layer DiT alone (58 GB
                bf16), B=2: step time and peak memory.
50. e2e-mochi — ``inference-mochi`` at 84×480×848 (22,516 tokens) at full
                width and depth, 2 of 64 steps, 4 of 14 latent frames
                decoded; every joint attention on K4 at d=128.
51. K-flux    — Flux's d=128 attention on the Hopper designs against the
                plain versions, by CUDA events and device time beside
                flash_fwd.cu / flash_bwd.cu, SDPA and the bound: K2 online
                at sampling's 4,592 tokens (B=1, H=24: 4,080 image + 512
                T5), K5 online with the LSE (K3's kernel) and K8 at LoRA
                training's 2,816 (768×768).
52. reference-flux — the Flux-dev flow narrow (dim 256, 2 heads of d=128,
                1 double and 2 single blocks), card vs CPU, the DiT in
                bf16 (K2 on K3's kernel) and in f32 (K2 on the f32
                design): one DiT call over 128 image + 32 text tokens, 2
                steps, the decode; then one narrow bf16 LoRA step (K5
                online, K8) card vs CPU.
53. e2e-flux-dev, e2e-flux-schnell — ``inference-flux-dev`` (28 steps,
                embedded guidance) and ``inference-flux-schnell`` (4 steps)
                at 768×1360, full width and depth (dim 3072, 19 double and
                38 single blocks, bf16; T5-XXL, CLIP-L, the 2D VAE): 57 K2
                a step on K3's kernel, none on flash_fwd.cu.
54. train-flux-lora — ``flux_lora.yaml`` at full width, LoRA rank 16,
                768×768, batch 1, 3 steps through the trainer on batches of
                packed latents (the port's VAE encode of a seeded image)
                and the caption: K5 and K8 57 a step at d=128.
55. e2e-v2v   — a seeded 16-frame 320×512 mp4 through ``inference-v2v-ms``
                (VideoCrafter2, DDIM from strength 0.4: 20 of 50 steps,
                CFG 7.5) and the enhancement model (``V2VEnhanceFlow``,
                v2v_enhance_unet.yaml, all 50 steps) through ``cli/v2v``:
                the UNet's K2 and K1 on the persistent kernel.
56. reference-v2v — the enhancement model narrow (the UNet in f32), card vs
                CPU: conditioning latents, one UNet call, the enhanced
                pixels; 57. its control (every card attention output
                scaled by 1 + 1e-3), which must fail.
58. K-f32     — the f32 design (flash_fwd_f32_sm90.cu, templated on d =
                64, 80, 128) at the LLaVA tower's 577², 16 heads of d=64
                (route K1), the CLIP ViT-H/14 embedder's 256², d=80 (split
                into 4 key ranges) and the LLaMA over the I2V prompt's 934
                tokens (causal, d=128), against the f32 plain version with
                the LSE; each timed by events, device and host time beside
                flash_fwd.cu (in turns), SDPA and the bound.
59. hunyuan-i2v-encode — the full I2V prompt chain at full width: the
                ViT-L/14-336 tower (f32, 24 K1 on the f32 design),
                LlavaProjector (1024 → 4096) and encode_text_i2v (LLaMA
                4096×32 in f32 over 934 tokens) for token replace and
                latent concat: shapes, seconds, launches.
60. reference-hunyuan-i2v — the narrow I2V flow card vs CPU, its DiT in
                bf16 and f32, with i2v_condition_type None and token
                replace; 61a. its control (the card's DiT modulating the
                first frame with vec in place of vec_tr), which must fail.
61. e2e-hunyuan-i2v — ``inference-hunyuan-i2v-720p`` as shipped (32 input
                channels) from one seeded PNG at 129×720×1280, full width
                and depth, 1 of 50 steps, 2 latent frames decoded: K3 60 a
                step on K3's kernel, the LLaMA's 32 f32 K2 split.
62. K-os12    — Open-Sora 1.2's spatial K2 (B=60, 3,600², H=16, d=72)
                and cross K4 (B=2, 108,000 × 300 T5 keys, masked) on the
                persistent kernel against the plain version, timed beside
                flash_fwd.cu, SDPA and the bound.
63. reference-opensora12 — the narrow STDiT3 and STDiT8 flows card vs
                CPU, and one narrow bf16 rectified-flow training step.
64. e2e-opensora12 — ``run_inference`` on opensorav12_stdit3_720p.yaml at
                its latent size, 30×720×1280 (overrides, the config having
                no inference section), full width and depth, CFG, T5-XXL
                over 300 tokens: 28 K2 and 28 K4 a step on the persistent
                kernel, 4 of the 30 steps (all 30 with --opensora12).
                With --opensora12 alone, 65. profile-opensora12: one
                traced full-width STDiT3 call (the work of a step).
66. K-serve   — STDiT-XL/2's attention at the 4-slot serving engine's
                shapes (B = 8 under CFG): the spatial K2 (B = 128 = 8 × 16
                frames, 256², H=16, d=72) and the cross K4 (B = 8, 4,096 ×
                120 T5 keys, masked) on the persistent kernel against the
                plain version, timed beside flash_fwd.cu, SDPA and the
                bound.
67. reference-serve — the continuous engine card vs CPU in f32 with
                staggered arrivals, on tiny_t2v.yaml's DDIM flow and on the
                narrow HunyuanVideo flow (flow matching); the tiny flow
                int8-quantized on both sides: a w8a8 call and 2 steps.
68. serve     — opensorav10_256x256.yaml as shipped (STDiT-XL/2, T5-XXL,
                the 2D VAE, DDIM 50 steps, CFG 7.0, 16×256×256), built once,
                behind each service's HTTP server on 127.0.0.1 in this
                process: InferenceService (2 requests, /healthz,
                /metrics), BatchingInferenceService (4 concurrent requests,
                one batched run), ContinuousBatchingService (4 slots, 6
                staggered requests, one request's latents beside a solo
                sample); the engine's seconds a step at 1–4 occupied slots
                and one traced 4-slot step; int8: bytes (≤ 0.55× bf16), a
                w8a8 call (within 0.05 of bf16), its step time, one request
                through each of two services.  28 K2 and 28 K4 a denoiser
                call on the persistent kernel.
69. K-ring    — the ring's hop functions at full width without
                collectives: HunyuanVideo 13B's self-attention at
                129×720×1280 (B=1, S=119,056, H=24, d=128, bf16, RMSNormed
                q and k) split into P=4 blocks of 29,764, each query block
                attended to each key block by ``_hop_attention`` (16 K5
                launches, online with the LSE, on K3's kernel) and merged
                by ``merge_hop``, against one unsharded online call (K2)
                and the unsharded LSE (K5); the backward at the LoRA shape
                (7,456 tokens): 16 ``_hop_backward`` launches (K8 on
                flash_bwd_sm90 with the global output and LSE) against one
                unsharded K8; one hop each way against its plain version;
                each hop timed (events and CUDA-graph device time) beside
                its bound, the plain version and cuDNN (forward with the
                LSE; SDPA's backward), the rings beside the unsharded
                calls.  69a. K-ulysses: the Ulysses
                local call at Wan 2.1 1.3B's shape on H/P = 6 heads
                (flash_fwd K5 and flash_bwd K8) against its plain version,
                timed likewise.
70. sp-collective — ``sp_attention`` forward and backward at Wan 1.3B's
                self-attention (B=2, 32,760 tokens, H=12, d=128, bf16)
                through Ulysses and the ring at P=2 and 4 and the 2×2
                hybrid, the ranks threads of this process over torch's
                threaded process group (``tests/torch_ranks.py``: every
                collective synchronises the device), every rank's output
                and gradients against the unsharded call within 2e-2 of
                their max.  The counts are set to 0 just before and read
                just after: 28 K5 and 28 K8 ring hops and 6 Ulysses local
                calls each way, all on the Hopper designs at d = 128.
71. reference-parallel — at P=2 against P=1 on the card, TF32 off: the
                narrow HunyuanVideo flow (f32) under ``use_mesh`` and
                ``sequence_parallel``: a denoiser call and the latents
                after 2 steps (1e-4, 1e-3); one narrow Wan training step
                (bf16: the backward kernels take bf16 only; the online
                softmax on both sides) at {fsdp: 2} (FSDP2 over the
                threaded group), {sp: 2} and, on four ranks with a batch
                of 4, {fsdp: 2, sp: 2}, through the port's ``Trainer``
                and its ``mesh_scope`` (gates ``PAR_TRAIN_TOL``); the
                narrow StepVideo denoiser call (f32) after
                ``shard_for_tp`` at {tp: 2} (1e-4).
72. sp-torchrun — with two or more cards, ``torch.distributed.run``
                starts an NCCL rank a card (``--parallel-rank``): Ulysses
                and the ring at P = the card count, printed by rank 0; with
                one card it logs that it did not run.

They run in the order 1–5, 28, 16, 23, 11, 12, 6, 7, 29, 30, 31, 32,
33, 8–10, 13–15, 17–19, 21, 24, 25, 26, 27, 34–40, 41–44, 45–47, 49, 50,
51–57, 58–64, 66–68, 69–72, 20, 22 (48 runs after 46).
Each timed phase first logs the TF32 flags it runs under: PyTorch's
defaults (TF32 convolutions, f32 matrix products); the card-vs-CPU checks
(7, 9, 15, 18, 25, 32, 35, 42, 46, 48, 52, 56, 60, 63, 67, 71) turn TF32 off
inside
``tf32_off`` and restore the flags.
Every launch count (K1–K10) is set to 0 just before each main-path run
(the twenty-one sampling runs, the I2V prompt chain, the six training
runs, each served run of phase 68 and phase 70's collective path) and
read just after;
in each, no launch splits its keys but LLaMA's and StepLLM's f32 K2 and
the CLIP image embedder's f32 K2;
the kernels' JSON record, on the line before the last, gives each kernel's
launches summed over those runs (and phase 49's), per design
and,
for the Hopper
designs, per width: an entry for each Hopper kernel, with HunyuanVideo
training's d=128 K5 (K3's kernel with the LSE) and K8 (flash_bwd_sm90 at
width 128) apart from STDiT's d=72 K5 and K8, and one for the case of a
route's f32 design on a main path (LLaMA's f32 K2), each with its status
(K1, K3, K4, K5, K6, K7, K8 and K10 also give the old design's ms on the
same tensors, flash_fwd.cu for K1, K5 and K6, flash_bwd.cu for K7, K8 and
K10; K2, K4, K5 and K8 also the device times, K8 its host times and the
cross-attention's figures as cross_*; K1 its time at the training shape
with the LSE; K6 device and host times beside its unsplit walk's
(unsplit_*); K2 LLaMA's figures as llama_*, device and host times
beside flash_fwd.cu's; the ring's K5 and K8 hops and the Ulysses local
call with phase 70's launches, the ring's and the unsharded call's ms).
K1's and K6's bound_ms is
the largest of three floors: the bytes, the products and the exp2 (the
special-function units).  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch
from torch import nn

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG_5B = os.path.join(ROOT, "configs", "004_cogvideox", "cogvideo5b.yaml")
CONFIG_OS = os.path.join(ROOT, "configs", "003_opensora",
                         "opensorav10_256x256.yaml")
OUT_DIR = os.path.join(ROOT, "results", "chip_smoke")

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SHAPE_5B = dict(b=2, s=17776, h=48)   # 226 text + 13·30·45 video tokens
E2E_STEPS = 3
DECODE_LATENT_FRAMES = 4
K1_TOL = 2e-2   # of max|o|: bf16 output and bf16 p on both sides
LSE_TOL = 1e-3  # absolute, f32 LSE
# of max|ref|, card vs CPU: bf16 rounding in another summation order for
# one denoiser call and for the whole trajectory, where CFG scale 6
# multiplies the cond − uncond difference at each of 3 steps; f32 (TF32
# off) for the VAE decoding the same latents
REF_TOL_CALL = 3e-2
REF_TOL_TRAJ = 1e-1
REF_TOL_DECODE = 1e-3
# the same for the narrow UNet3D flows, which run in f32 on both sides: the
# sound runs read at most 3.2e-6 for a call and 1.2e-5 for the latents, the
# UNet in bf16 2.4e-2 and 1.0e-1
REF_VC_TOL_CALL = 1e-4
REF_VC_TOL_TRAJ = 1e-3
# reference-vc's control: every card attention output scaled by 1 + this
# must fail the check
REF_VC_CONTROL = 1e-3
OS_STEPS = 50        # Open-Sora e2e: every DDIM step of the config
OS_DEPTH = 28
OS_REF_STEPS = 5     # narrow Open-Sora card-vs-CPU trajectory
FWD_TOL = 2e-2       # K2/K4, of max|o|: bf16 output and bf16 p on both sides

CONFIG_2B_LORA = os.path.join(ROOT, "configs", "004_cogvideox",
                              "cogvideo2b_lora.yaml")
TOY_CSV = os.path.join(ROOT, "configs", "000_tiny", "toy_anno.csv")
SHAPE_2B = dict(b=1, s=17776, h=30)   # 226 text + 13·30·45 video tokens
TRAIN_STEPS = 3
# of max|grad| per output: p and ds are bf16 operands of the products and
# the gradients are bf16, against the f32 plain backward
BWD_TOL = 2e-2
# f32 flash_fwd against the f32 plain version, of max|o| (and absolute for
# the LSE): each product is split into bf16 hi + lo parts, ~16 mantissa bits
F32_TOL = 1e-4
# one narrow training step, card against CPU: both run the bf16 model, the
# card through the kernels, the CPU through their plain versions, summing
# in other orders; loss relative, gradients of max|g|
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 3e-2

CONFIG_HY = os.path.join(ROOT, "configs", "007_hunyuanvideo",
                         "hunyuanvideo_t2v.yaml")
# 129×720×1280 → 33×45×80 video tokens after the (1, 2, 2) patch, + 256 text
SHAPE_HY = dict(b=1, s=33 * 45 * 80 + 256, h=24)
# of the config's 50: every step costs the same (1 since the serving
# phases joined the whole run, 2 before)
HY_STEPS = 1
HY_DECODE_LATENT_FRAMES = 2  # 5 pixel frames: the f32 decode of 33 won't fit
HY_DEPTH = 20 + 40           # double + single blocks, one K3 launch each
HY_LLAMA_LAYERS = 32         # one f32 K2 (causal, 256 tokens) each
HY_LLAMA_HEADS = 32          # of d=128
HY_REF_STEPS = 2             # narrow HunyuanVideo card-vs-CPU trajectory
# HunyuanVideo LoRA training through the registry's command: 720×1280 held,
# frames cut to the largest of 33, 17, 9, 5 whose run leaves ≥ 3 GB free:
# 33, 17 and 9 run out of memory (``--hunyuan-train FRAMES``)
HY_LORA_COMMAND = "train-hunyuan-t2v-lora"
HY_TRAIN_FRAMES = 5
HY_TRAIN_SIZE = (720, 1280)
# tokens of each joint attention: the latent frames' 45×80 patches + 256 text
HY_TRAIN_TOKENS = ((HY_TRAIN_FRAMES - 1) // 4 + 1) * 45 * 80 + 256

CONFIG_15_T2V = os.path.join(ROOT, "configs", "005_cogvideox1.5",
                             "cogvideox1.5_5b_t2v.yaml")
CONFIG_15_I2V = os.path.join(ROOT, "configs", "005_cogvideox1.5",
                             "cogvideox1.5_5b_i2v.yaml")
COG_I2V_COMMAND = "inference-cogvideo-i2v-diffusers"
COG15_T2V_COMMAND = "inference-cogvideox-15-5b-t2v"
COG15_I2V_COMMAND = "inference-cogvideox-15-5b-i2v"
COG_PROMPT = "a panda playing guitar by a lake at sunset"
# CogVideoX 1.5 at 49×480×720: 13 latent frames and one sampled in front
# for the (2, 2, 2) patch → 7×30×45 = 9,450 video tokens + 224 text tokens;
# 75 full query tiles and a last one of 74 rows.  B=2 under CFG
SHAPE_COG15 = dict(b=2, s=7 * 30 * 45 + 224, h=48)
COG15_SAMPLED_FRAMES = 14    # latent frames sampled: 13 kept + 1 in front
COG_DEPTH = 42               # MMDiT blocks: one K1 launch each a step

CONFIG_WAN14 = os.path.join(ROOT, "configs", "008_wanvideo",
                            "wan2_1_t2v_14B.yaml")
CONFIG_WAN13 = os.path.join(ROOT, "configs", "008_wanvideo",
                            "wan2_1_t2v_1_3B.yaml")
WAN14_COMMAND = "inference-wanvideo-t2v-720p"
WAN13_COMMAND = "inference-wanvideo-t2v-1-3B"
WAN_PROMPT = "a red panda climbing a snow-covered pine tree at dawn"
WAN_TEXT = 512               # umT5 tokens: the cross-attention's keys
# CFG doubles the batch: 81×720×1280 → 21×90×160 latents → 21×45×80 =
# 75,600 tokens after the (1, 2, 2) patch; 81×480×832 → 21×30×52 = 32,760
SHAPE_WAN14 = dict(b=2, s=21 * 45 * 80, h=40)
SHAPE_WAN13 = dict(b=2, s=21 * 30 * 52, h=12)
WAN_K3_CASES = {
    "self 14B": (2, SHAPE_WAN14["s"], SHAPE_WAN14["s"], 40),
    "self 1.3B": (2, SHAPE_WAN13["s"], SHAPE_WAN13["s"], 12),
    "cross 14B": (2, SHAPE_WAN14["s"], WAN_TEXT, 40),
}
# of the config's 50: every step costs the same (1 since the serving
# phases joined the whole run, 2 before)
WAN14_STEPS = 1
WAN14_DEPTH = 40             # layers: a self- and a cross-attention each
# of the 1.3B config's 50 (every step costs the same): cut from 50 to keep
# the script's time while VideoCrafter2's fine-tunes joined it
WAN13_STEPS = 10
WAN13_DEPTH = 30
WAN_REF_STEPS = 3            # narrow Wan card-vs-CPU trajectory (UniPC 1, 2, 1)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def tf32_flags() -> dict:
    """The TF32 switches that f32 convolutions (cuDNN) and f32 matrix
    products read."""
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@contextlib.contextmanager
def tf32_off():
    """Full f32 convolutions and products inside, for a card-vs-CPU check;
    the flags it found are restored on the way out, so that every later
    phase runs under PyTorch's defaults (TF32 convolutions, f32 products).
    Also a decorator."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


_T0 = time.perf_counter()


def timed_phase(phase: str, fn, *args):
    """Run a timed phase after a log line of the TF32 flags it runs under
    and the script's seconds so far; log its own seconds after it."""
    t0 = time.perf_counter()
    log(phase, tf32=tf32_flags(), script_sec=f"{t0 - _T0:.1f}")
    out = fn(*args)
    log(phase, phase_sec=f"{time.perf_counter() - t0:.1f}")
    return out


def cuda_time_ms(fn, reps: int) -> float:
    """CUDA-event time per call of ``fn`` over ``reps`` calls, after one
    call that warms it up (a kernel's first launch loads its code)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_ms(args, kw, reps: int):
    """Time of torch's scaled_dot_product_attention on the same tensors, a
    yardstick only: the fastest of its backends (flash, cuDNN, efficient)
    that takes the inputs, and that backend's name.  Its default choice is
    timed too and logged beside: at d=72 it can pick a far slower one."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {"default": cuda_time_ms(lambda: sdpa(*args, **kw), reps)}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sdpa(*args, **kw)
                torch.cuda.synchronize()
                times[backend.name] = cuda_time_ms(
                    lambda: sdpa(*args, **kw), reps)
        except RuntimeError:   # this backend does not take the inputs
            continue
    log("sdpa", **{k: f"{v:.4f}" for k, v in times.items()})
    best = min((k for k in times if k != "default"), key=times.get)
    return times[best], best


def sdpa_device_ms(args, kw, reps: int):
    """The least device time per call (``device_ms``) of
    scaled_dot_product_attention's backends that take the inputs (a
    yardstick only), and that backend."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from videotuna_tpu_torch.kernels.attribution import device_ms
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                times[backend.name] = device_ms(lambda: sdpa(*args, **kw),
                                                reps)
        except RuntimeError:   # this backend does not take the inputs
            continue
    best = min(times, key=times.get)
    return times[best], best


def host_ms(fn, reps: int) -> float:
    """Host time per call of ``fn`` (the wrapper's checks, allocations and
    launch), the device's work left to finish after the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def compare_designs(A, label: str, q, k, v, emit_lse: bool,
                    rec: dict, kv_valid=None) -> None:
    """The Hopper design (flash_fwd_sm90.cu, the K2 or K5 route, or K4 with
    the key mask ``kv_valid``) beside the old mma.sync design (flash_fwd.cu)
    on the same STDiT tensors, and SDPA, by CUDA events around 50 calls,
    with each wrapper's host time per call; adds the old design's ms to
    ``rec``.  The device times come in the last phase
    (``device_times``)."""
    route = "K4" if kv_valid is not None else "K5" if emit_lse else "K2"
    sm = q.shape[-1] ** -0.5
    new = lambda: A.flash_fwd(q, k, v, sm_scale=sm, kv_valid=kv_valid,
                              emit_lse=emit_lse, route=route)
    old = lambda: A._flash_fwd_mma(q, k, v, sm, False, kv_valid, None,
                                   emit_lse)
    o_new, o_old = new(), old()
    if emit_lse:
        o_new, o_old = o_new[0], o_old[0]
    torch.cuda.synchronize()
    diff = (o_new.float() - o_old.float()).abs().max().item()
    rec["old_design_ms"] = cuda_time_ms(old, reps=50)
    log(route, case=label, compare="flash_fwd_sm90 (Hopper, persistent) vs "
        "flash_fwd.cu (mma.sync) vs sdpa, CUDA events", ms=f"{rec['ms']:.4f}",
        old_design_ms=f"{rec['old_design_ms']:.4f}",
        library_ms=f"{rec['library_ms']:.4f}",
        bound_ms=f"{rec['bound_ms']:.4f}",
        host_ms=f"{host_ms(new, 200):.4f}",
        old_design_host_ms=f"{host_ms(old, 200):.4f}",
        max_abs_diff_old_vs_new=f"{diff:.3e}")


def device_times(A, k2: dict, k5: dict, k4: dict, k8: dict) -> None:
    """Last phase: device time per call (``device_ms``: 50 calls in one
    CUDA graph, its replay timed) of K2 and K5 (flash_fwd_sm90), of the old
    design (flash_fwd.cu) and of SDPA's fastest backend on STDiT's tensors
    (B=32 and B=16, S=256, H=16, d=72), into ``k2`` and ``k5``; of K4
    at STDiT's cross-attention (B=2, 4096 queries over 120 keys, the prefix
    mask), without and with the LSE, beside the old design and SDPA with
    the boolean mask, into ``k4``; and of K8 (flash_bwd_rows_sm90) beside
    the old design (flash_bwd.cu) at STDiT's training shapes, spatial (B=16)
    and cross (B=1, 13 of 120 keys, the words packed once as the training
    forward does), into ``k8`` (the cross figures as ``cross_*``)."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    gen = torch.Generator(device="cuda").manual_seed(10)
    for route, rec, b in (("K2", k2, 32), ("K5", k5, 16)):
        q, k, v = (_rand((b, 256, 16, 72), gen) for _ in range(3))
        lse = route == "K5"
        sm = 72 ** -0.5
        rec["device_ms"] = device_ms(lambda: A.flash_fwd(
            q, k, v, sm_scale=sm, emit_lse=lse, route=route), reps=50)
        rec["old_design_device_ms"] = device_ms(lambda: A._flash_fwd_mma(
            q, k, v, sm, False, None, None, lse), reps=50)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rec["library_device_ms"], backend = sdpa_device_ms((qt, kt, vt), {},
                                                           reps=50)
        log(route, case=f"stdit-xl2 spatial B{b}" + (", emit_lse" * lse),
            compare="flash_fwd_sm90 (Hopper, persistent) vs flash_fwd.cu "
            "(mma.sync) vs sdpa, device time per call (CUDA-graph replay)",
            device_ms=f"{rec['device_ms']:.4f}",
            old_design_device_ms=f"{rec['old_design_device_ms']:.4f}",
            library_device_ms=f"{rec['library_device_ms']:.4f}",
            library=f"scaled_dot_product_attention[{backend}]",
            bound_ms=f"{rec['bound_ms']:.4f}")
        del q, k, v, qt, kt, vt
    q = _rand((2, 4096, 16, 72), gen)
    k, v = (_rand((2, 120, 16, 72), gen) for _ in range(2))
    m = torch.ones((2, 120), dtype=torch.bool, device="cuda")
    m[0, 13:] = False
    sm = 72 ** -0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib, backend = sdpa_device_ms((qt, kt, vt),
                                  {"attn_mask": m[:, None, None, :]}, reps=50)
    for lse in (False, True):
        new = device_ms(lambda: A.flash_fwd(q, k, v, sm_scale=sm, kv_valid=m,
                                            emit_lse=lse), reps=50)
        old = device_ms(lambda: A._flash_fwd_mma(q, k, v, sm, False, m, None,
                                                 lse), reps=50)
        if not lse:
            k4.update(device_ms=new, old_design_device_ms=old,
                      library_device_ms=lib)
        else:
            k4.update(lse_device_ms=new, lse_old_design_device_ms=old)
        log("K4", case="stdit-xl2 cross, prefix mask" + (", emit_lse" * lse),
            compare="flash_fwd_sm90 (Hopper, persistent, key mask) vs "
            "flash_fwd.cu (mma.sync) vs sdpa(attn_mask), device time per "
            "call (CUDA-graph replay)", device_ms=f"{new:.4f}",
            old_design_device_ms=f"{old:.4f}",
            library_device_ms=f"{lib:.4f}",
            library=f"scaled_dot_product_attention[{backend}](attn_mask)",
            bound_ms=f"{k4['bound_ms']:.4f}")
    del q, k, v, qt, kt, vt
    for prefix, (b, sq, sk) in (("", (16, 256, 256)),
                                ("cross_", (1, 4096, 120))):
        q, g = (_rand((b, sq, 16, 72), gen) for _ in range(2))
        k, v = (_rand((b, sk, 16, 72), gen) for _ in range(2))
        m = words = None
        if prefix:
            m = torch.zeros((b, sk), dtype=torch.bool, device="cuda")
            m[:, :13] = True
            words = A._pack_mask_words(m, b, sk)
        out, lse = A.flash_fwd(q, k, v, sm_scale=sm, kv_valid=m,
                               emit_lse=True)
        new = device_ms(lambda: A.flash_bwd(
            q, k, v, out, g, lse, sm_scale=sm, kv_valid=m, mask_words=words),
            reps=50)
        old = device_ms(lambda: A._flash_bwd_mma(q, k, v, out, g, lse, sm,
                                                 False, m), reps=50)
        k8.update({f"{prefix}device_ms": new,
                   f"{prefix}old_design_device_ms": old})
        log("K8", case="stdit-xl2 " + ("cross, 13 of 120 keys" if prefix
                                       else "spatial B16"),
            compare="flash_bwd_rows_sm90 (Hopper, single pass) vs "
            "flash_bwd.cu (two-pass mma.sync), device time per call "
            "(CUDA-graph replay)", device_ms=f"{new:.4f}",
            old_design_device_ms=f"{old:.4f}",
            library_device_ms=f"{k8[prefix + 'library_device_ms']:.4f}",
            bound_ms=f"{k8[prefix + 'bound_ms']:.4f}")
        del q, k, v, g, out, lse


# ---------------------------------------------------------------- phase 3
def _qkv(b, sq, sk, h, gen):
    """q, k LayerNormed per head, like the MMDiT's (bounded logits)."""
    q, k, v = (torch.randn((b, s, h, 64), generator=gen, device="cuda")
               for s in (sq, sk, sk))
    q = torch.nn.functional.layer_norm(q, (64,))
    k = torch.nn.functional.layer_norm(k, (64,))
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def _plain_chunked(A, q, k, v, static_max, rows=256):
    """The plain version with the LSE over all query rows, a block of rows
    at a time (the full score matrix would not fit)."""
    outs, lses = [], []
    for i in range(0, q.shape[1], rows):
        o, lse = A.flash_fwd_plain(q[:, i:i + rows], k, v,
                                   sm_scale=q.shape[-1] ** -0.5,
                                   static_max=static_max, emit_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _k1(A, q, k, v, static_max, emit_lse=False, route="K1"):
    return A.flash_fwd(q, k, v, sm_scale=0.125, static_max=static_max,
                       emit_lse=emit_lse, route=route)


def check_k1(A) -> dict:
    """K1 (and K6) through ``flash_fwd`` on the persistent Hopper kernel
    (flash_fwd_sm90.cu, D=64) against the plain version at the
    CogVideoX-5B shape in both softmax modes with the LSE and at ragged
    shapes; timed beside flash_fwd.cu (the mma.sync A/B baseline) and
    SDPA on the same tensors."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h = SHAPE_5B["b"], SHAPE_5B["s"], SHAPE_5B["h"]
    q, k, v = _qkv(b, s, s, h, gen)
    flops = 4.0 * b * h * s * s * 64
    io_bytes = 4 * q.numel() * q.element_size()
    exp2_ms = _exp2_floor_ms(b * h * s * s)
    bound_ms, bound_by = _bound(flops, io_bytes, exp2_ms)
    record = {}
    for static_max in (0.0, None):
        before = (A.flash_fwd.launches_sm90["K1"], A.flash_fwd.tma_copies)
        out, lse = _k1(A, q, k, v, static_max, emit_lse=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, ref_lse = _plain_chunked(A, q, k, v, static_max)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = (err <= K1_TOL * scale and lse_err <= LSE_TOL
              and (A.flash_fwd.launches_sm90["K1"], A.flash_fwd.tma_copies)
              == (before[0] + 1, before[1]))
        ms = cuda_time_ms(lambda: _k1(A, q, k, v, static_max), reps=5)
        log("K1", mode="static_max=0" if static_max == 0.0 else "online",
            shape=f"B{b}xS{s}xH{h}xd64", kernel="flash_fwd_sm90 persistent",
            max_abs_err=f"{err:.3e}", tol=f"{K1_TOL * scale:.3e}",
            lse_err=f"{lse_err:.3e}", lse_tol=LSE_TOL, ms=f"{ms:.3f}",
            bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
            exp2_floor_ms=f"{exp2_ms:.3f}", plain_ms=f"{plain_ms:.1f}",
            tflops=f"{flops / ms / 1e9:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"(static_max={static_max}), or did not "
                                 "launch flash_fwd_sm90 in place")
        if static_max == 0.0:   # the main path's mode
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            # flash_fwd.cu (the mma.sync design, K1's A/B baseline) on the
            # same tensors
            old = A._flash_fwd_mma(q, k, v, 0.125, False, None, 0.0, False)
            torch.cuda.synchronize()
            old_err = (old.float() - ref.float()).abs().max().item()
            del old
            old_ms = cuda_time_ms(lambda: A._flash_fwd_mma(
                q, k, v, 0.125, False, None, 0.0, False), reps=5)
            record.update(old_design_ms=old_ms)
            log("K1", compare="flash_fwd.cu (mma.sync, the A/B baseline) at "
                "K1's shape", mode="static_max=0",
                max_abs_err=f"{old_err:.3e}", tol=f"{K1_TOL * scale:.3e}",
                ms=f"{old_ms:.3f}", k1_ms=f"{ms:.3f}",
                ok=old_err <= K1_TOL * scale)
            if old_err > K1_TOL * scale:
                raise AssertionError("flash_fwd.cu disagrees with K1's plain "
                                     "version at K1's shape")
        del out, lse, ref, ref_lse
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    record["library_ms"], backend = sdpa_ms((qt, kt, vt), {}, reps=5)
    log("K1", library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{record['library_ms']:.3f}")
    del q, k, v, qt, kt, vt

    # ragged shapes; 300 × 4322 (5 ranges) and 17 × 4322 (9) split their
    # keys, the others stay unsplit
    for sq, sk in ((200, 200), (300, 4322), (1, 64), (130, 300),
                   (17, 4322)):
        q, k, v = _qkv(2, sq, sk, 4, gen)
        splits = A._fwd_plan("sm90", q, k, False, False).splits
        for static_max in (0.0, None):
            split_before = A.flash_fwd.launches_split["K1"]
            out, lse = _k1(A, q, k, v, static_max, emit_lse=True)
            ref, ref_lse = A.flash_fwd_plain(
                q, k, v, sm_scale=0.125, static_max=static_max, emit_lse=True)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = (err <= K1_TOL * scale and lse_err <= LSE_TOL
                  and A.flash_fwd.launches_split["K1"]
                  == split_before + (splits > 1))
            log("K1", mode="static_max=0" if static_max == 0.0 else "online",
                shape=f"B2xSq{sq}xSk{sk}xH4xd64", splits=splits,
                max_abs_err=f"{err:.3e}", tol=f"{K1_TOL * scale:.3e}",
                lse_err=f"{lse_err:.3e}", ok=ok)
            if not ok:
                raise AssertionError(f"K1 disagrees at Sq={sq}, Sk={sk}, or "
                                     "its split was not counted")
    if A._fwd_split_plan("sm90", b, h, s, s, 64, False, False,
                         A._sm_count(torch.device("cuda"))).splits != 1:
        raise AssertionError("K1's main-path shape must stay unsplit")
    record["k6"] = check_k6(A, gen)
    return record


def check_k6(A, gen) -> dict:
    """K6 (``pack2=True``: K1's function in online mode, route K6) at its
    A/B shape, B=2, 300 queries over 4,322 keys, H=4, d=64: the plan cuts
    each query tile's keys into 5 ranges (120 units for 132 SMs), the
    persistent kernel walks them and the combine sums their partials.
    Against the plain version with the LSE, online and under the fixed
    max; the same bits from a second call; counted as a split launch.
    Timed by CUDA events, device time (CUDA-graph replay) and host time,
    beside the unsplit walk on the same tensors (the private launcher with
    one range), the old flash_fwd.cu and SDPA (wall and device)."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    b, sq, sk, h = 2, 300, 4322, 4
    q, k, v = _qkv(b, sq, sk, h, gen)
    splits = A._fwd_plan("sm90", q, k, False, False).splits
    for static_max in (None, 0.0):
        before = (dict(A.flash_fwd.launches), dict(A.flash_fwd.launches_sm90),
                  dict(A.flash_fwd.launches_split))
        run = lambda: A.flash_fwd(q, k, v, sm_scale=0.125,
                                  static_max=static_max, emit_lse=True,
                                  route="K6")
        (out, lse), (out2, lse2) = run(), run()
        ref, ref_lse = A.flash_fwd_plain(q, k, v, sm_scale=0.125,
                                         static_max=static_max, emit_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        scale = ref.float().abs().max().item()
        same = torch.equal(out, out2) and torch.equal(lse, lse2)
        counted = all(c == dict(bc, K6=bc["K6"] + 2) for c, bc in zip(
            (A.flash_fwd.launches, A.flash_fwd.launches_sm90,
             A.flash_fwd.launches_split), before))
        ok = (err <= K1_TOL * scale and lse_err <= LSE_TOL and same
              and counted and splits == 5)
        log("K6", route="flash_fwd route K6, flash_fwd_sm90 persistent, "
            "split keys + combine", mode="online" if static_max is None
            else "static_max=0", shape=f"B{b}xSq{sq}xSk{sk}xH{h}xd64",
            splits=splits, max_abs_err=f"{err:.3e}",
            tol=f"{K1_TOL * scale:.3e}", lse_err=f"{lse_err:.3e}",
            lse_tol=LSE_TOL, same_bits=same, counted_split=counted, ok=ok)
        if not ok:
            raise AssertionError("K6 disagrees with its plain version, is "
                                 "not the same bits twice, or did not run "
                                 "the split design (5 ranges)")
        if static_max is None:
            rec = dict(max_abs_err=err)
        del out, lse, out2, lse2, ref, ref_lse
    before = dict(A.flash_fwd.launches_split)
    out = A.flash_attention(q, k, v, pack2=True)
    ref = A.flash_fwd_plain(q, k, v, sm_scale=0.125)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if err > K1_TOL * ref.float().abs().max().item() \
            or A.flash_fwd.launches_split != dict(before,
                                                  K6=before["K6"] + 1):
        raise AssertionError("flash_attention(pack2=True) disagrees or did "
                             "not run the split design")
    new = lambda: A.flash_attention(q, k, v, pack2=True)
    unsplit = lambda: A._flash_fwd_sm90(q, k, v, 0.125, None, False, splits=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    rec["bound_ms"], rec["bound_by"] = _bound(
        4.0 * b * h * sq * sk * 64,
        (2 * q.numel() + 2 * k.numel()) * q.element_size(),
        _exp2_floor_ms(b * h * sq * sk))
    rec["library_ms"], backend = sdpa_ms((qt, kt, vt), {}, reps=20)
    rec["library_device_ms"], dev_backend = sdpa_device_ms((qt, kt, vt), {},
                                                           reps=20)
    # in turns: split, unsplit, unsplit, split
    dev = [device_ms(fn, reps=20) for fn in (new, unsplit, unsplit, new)]
    rec.update(
        ms=cuda_time_ms(new, reps=20), device_ms=min(dev[0], dev[3]),
        host_ms=host_ms(new, 200),
        unsplit_ms=cuda_time_ms(unsplit, reps=20),
        unsplit_device_ms=min(dev[1], dev[2]),
        unsplit_host_ms=host_ms(unsplit, 200),
        plain_ms=cuda_time_ms(lambda: A.flash_fwd_plain(
            q, k, v, sm_scale=0.125), reps=5),
        old_design_ms=cuda_time_ms(lambda: A._flash_fwd_mma(
            q, k, v, 0.125, False, None, None, False), reps=20),
        old_design_device_ms=device_ms(lambda: A._flash_fwd_mma(
            q, k, v, 0.125, False, None, None, False), reps=20))
    log("K6", compare="split (5 ranges + combine) vs the unsplit walk "
        "(splits=1) vs flash_fwd.cu vs sdpa",
        ms=f"{rec['ms']:.4f}", device_ms=f"{rec['device_ms']:.4f}",
        device_ms_turns="/".join(f"{x:.4f}" for x in dev),
        host_ms=f"{rec['host_ms']:.4f}",
        unsplit_ms=f"{rec['unsplit_ms']:.4f}",
        unsplit_device_ms=f"{rec['unsplit_device_ms']:.4f}",
        unsplit_host_ms=f"{rec['unsplit_host_ms']:.4f}",
        old_design_ms=f"{rec['old_design_ms']:.4f}",
        old_design_device_ms=f"{rec['old_design_device_ms']:.4f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{rec['library_ms']:.4f}",
        library_device=f"scaled_dot_product_attention[{dev_backend}]",
        library_device_ms=f"{rec['library_device_ms']:.4f}",
        bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"],
        plain_ms=f"{rec['plain_ms']:.3f}")
    return rec


# ---------------------------------------------------------------- phases 4-5
def _rand(shape, gen, normed=False):
    x = torch.randn(shape, generator=gen, device="cuda")
    if normed:
        x = torch.nn.functional.layer_norm(x, (shape[-1],))
    return x.bfloat16()


def _check_fwd(A, label, q, k, v, **kw) -> float:
    """flash_fwd against flash_fwd_plain with the LSE; returns max|err|.
    The call is counted on its route, and on the Hopper design exactly
    when ``_fwd_design`` names it."""
    route = "K4" if kw.get("kv_valid") is not None else "K2"
    before = A.flash_fwd.launches[route]
    sm90 = A.flash_fwd.launches_sm90[route]
    design = A._fwd_design(route, q.dtype, q.shape[-1],
                           kw.get("causal", False), kw.get("kv_valid"), True,
                           kw.get("static_max"))
    out, lse = A.flash_fwd(q, k, v, emit_lse=True, **kw)
    ref, ref_lse = A.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    finite = torch.isfinite(ref_lse)
    inf_ok = torch.equal(torch.isfinite(lse), finite)
    lse_err = ((lse - ref_lse)[finite].abs().max().item()
               if finite.any() else 0.0)
    ok = (err <= FWD_TOL * scale and lse_err <= LSE_TOL and inf_ok
          and A.flash_fwd.launches[route] == before + 1
          and A.flash_fwd.launches_sm90[route] == sm90 + (design == "sm90"))
    b, sq, h, d = q.shape
    log(route, case=label, shape=f"B{b}xSq{sq}xSk{k.shape[1]}xH{h}xd{d}",
        kernel="flash_fwd_sm90" if design == "sm90" else "flash_fwd",
        causal=kw.get("causal", False), static_max=kw.get("static_max"),
        max_abs_err=f"{err:.3e}", tol=f"{FWD_TOL * scale:.3e}",
        lse_err=f"{lse_err:.3e}", lse_tol=LSE_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"{route} disagrees with its plain version "
                             f"({label})")
    return err


def _bound(flops: float, io_bytes: float, exp2_ms: float = 0.0):
    """The least time of the work: the larger of its bytes at the memory
    rate and its operations at their peak rates, the bf16 products' on the
    tensor cores and, where given, the exp2's on the special-function units
    (``exp2_ms``)."""
    t_ops = max(flops / PEAK_BF16_FLOPS, exp2_ms / 1e3)
    t_bytes = io_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _exp2_floor_ms(scores: float) -> float:
    """The special-function units' floor of ``scores`` exp2 (one a score):
    16 a clock per SM on 132 SMs at the H100's 1.98 GHz boost clock."""
    return scores / (16 * 132 * 1.98e9) * 1e3


def _time_record(A, q, k, v, sdpa_args, sdpa_kw, flops, io_bytes, **kw):
    """ms of the kernel, of its plain version and of SDPA on the same
    tensors (CUDA events), with the bound of the work."""
    ms = cuda_time_ms(lambda: A.flash_fwd(q, k, v, **kw), reps=50)
    plain_ms = cuda_time_ms(lambda: A.flash_fwd_plain(q, k, v, **kw), reps=5)
    library_ms, backend = sdpa_ms(sdpa_args, sdpa_kw, reps=50)
    bound_ms, bound_by = _bound(flops, io_bytes)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by), backend


def check_k2(A) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, d = 32, 256, 16, 72          # STDiT-XL/2 spatial, CFG batch
    q, k, v = (_rand((b, s, h, d), gen) for _ in range(3))
    err = _check_fwd(A, "stdit-xl2 spatial", q, k, v, sm_scale=d ** -0.5)
    for label, (bb, sq, sk, hh, dd, causal, smax) in {
            "d64 causal": (2, 333, 333, 2, 64, True, None),
            "d72 single query": (2, 1, 64, 2, 72, False, None),
            "d128 ragged long": (1, 300, 4322, 2, 128, False, None),
            "d256 fixed max": (1, 200, 200, 2, 256, False, 0.0)}.items():
        normed = smax is not None
        qq = _rand((bb, sq, hh, dd), gen, normed)
        kk = _rand((bb, sk, hh, dd), gen, normed)
        vv = _rand((bb, sk, hh, dd), gen)
        _check_fwd(A, label, qq, kk, vv, sm_scale=dd ** -0.5, causal=causal,
                   static_max=smax)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    rec, backend = _time_record(A, q, k, v, (qt, kt, vt), {},
                                flops=4.0 * b * h * s * s * d,
                                io_bytes=4 * q.numel() * q.element_size(),
                                sm_scale=d ** -0.5)
    log("K2", case="stdit-xl2 spatial timing", kernel="flash_fwd_sm90",
        ms=f"{rec['ms']:.4f}",
        bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"],
        plain_ms=f"{rec['plain_ms']:.3f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{rec['library_ms']:.4f}")
    compare_designs(A, "stdit-xl2 spatial", q, k, v, False, rec)
    rec.update(_check_llama_k2(A, gen))
    return dict(max_abs_err=err, **rec)


def _check_llama_k2(A, gen) -> dict:
    """K2 as HunyuanVideo's LLaMA runs it: f32, causal, B=1, 256 tokens,
    32 heads of d=128 (GQA's kv heads repeated before the call), on the f32
    design (flash_fwd_f32_sm90.cu: 10 units a head over split key ranges,
    the combine); against the f32 plain version (F32_TOL of max|o|, the
    LSE absolute), the same bits twice.  Timed by CUDA events, device time
    and host time beside the old flash_fwd.cu on the same tensors and SDPA
    with is_causal (wall and device).  Both kernels run each f32 product as
    three bf16 tensor-core products (hi·hi + hi·lo + lo·hi), so the bound
    takes the causal half of the scores three times at the bf16 rate,
    beside q, k, v and o in f32."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    b, s, h, d = 1, 256, HY_LLAMA_HEADS, 128
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(sm_scale=d ** -0.5, causal=True)
    counts = lambda: (A.flash_fwd.launches["K2"],
                      A.flash_fwd.launches_sm90["K2"],
                      A.flash_fwd.launches_f32["K2"],
                      A.flash_fwd.launches_split["K2"])
    before = counts()
    out, lse = A.flash_fwd(q, k, v, emit_lse=True, **kw)
    out2, lse2 = A.flash_fwd(q, k, v, emit_lse=True, **kw)
    ref, ref_lse = A.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = F32_TOL * ref.abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    same = torch.equal(out, out2) and torch.equal(lse, lse2)
    old = lambda: A._flash_fwd_mma(q, k, v, kw["sm_scale"], True, None, None,
                                   False)
    old_err = (old() - ref).abs().max().item()
    ok = (err <= tol and lse_err <= F32_TOL and same and old_err <= tol
          and counts() == (before[0] + 2, before[1], before[2] + 2,
                           before[3] + 2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, backend = sdpa_ms((qt, kt, vt), {"is_causal": True},
                                  reps=50)
    lib_dev, dev_backend = sdpa_device_ms((qt, kt, vt), {"is_causal": True},
                                          reps=50)
    bound_ms, bound_by = _bound(3 * 4.0 * b * h * d * s * (s + 1) / 2,
                                4 * q.numel() * q.element_size())
    new = lambda: A.flash_fwd(q, k, v, **kw)
    # in turns: new, old, old, new
    dev = [device_ms(fn, reps=50) for fn in (new, old, old, new)]
    rec = dict(llama_max_abs_err=err,
               llama_ms=cuda_time_ms(new, reps=50),
               llama_device_ms=min(dev[0], dev[3]),
               llama_host_ms=host_ms(new, 200),
               llama_old_design_ms=cuda_time_ms(old, reps=50),
               llama_old_design_device_ms=min(dev[1], dev[2]),
               llama_old_design_host_ms=host_ms(old, 200),
               llama_plain_ms=cuda_time_ms(
                   lambda: A.flash_fwd_plain(q, k, v, **kw), reps=5),
               llama_bound_ms=bound_ms, llama_bound_by=bound_by,
               llama_library_ms=library_ms, llama_library_device_ms=lib_dev)
    log("K2", case="llama f32 causal (HunyuanVideo text encode)",
        shape=f"B{b}xS{s}xH{h}xd{d}", kernel="flash_fwd_f32_sm90",
        dtype="f32", splits=A._fwd_plan("f32", q, k, True, False).splits,
        max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
        lse_err=f"{lse_err:.3e}", lse_tol=F32_TOL, same_bits=same,
        old_design_max_abs_err=f"{old_err:.3e}",
        ms=f"{rec['llama_ms']:.4f}",
        device_ms=f"{rec['llama_device_ms']:.4f}",
        device_ms_turns="/".join(f"{x:.4f}" for x in dev),
        host_ms=f"{rec['llama_host_ms']:.4f}",
        old_design_ms=f"{rec['llama_old_design_ms']:.4f}",
        old_design_device_ms=f"{rec['llama_old_design_device_ms']:.4f}",
        old_design_host_ms=f"{rec['llama_old_design_host_ms']:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        plain_ms=f"{rec['llama_plain_ms']:.4f}",
        library=f"scaled_dot_product_attention[{backend}](is_causal)",
        library_ms=f"{library_ms:.4f}",
        library_device=f"scaled_dot_product_attention[{dev_backend}]"
                       "(is_causal)",
        library_device_ms=f"{lib_dev:.4f}", ok=ok)
    if not ok:
        raise AssertionError("K2 (f32 causal, LLaMA's shape) disagrees with "
                             "its plain version, is not the same bits "
                             "twice, or did not launch the split f32 design")
    return rec


def check_k4(A) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, sq, sk, h, d = 2, 4096, 120, 16, 72   # STDiT-XL/2 cross-attention
    q = _rand((b, sq, h, d), gen)
    k, v = (_rand((b, sk, h, d), gen) for _ in range(2))
    masks = {}
    for label in ("prefix", "strided", "empty row"):
        m = torch.ones((b, sk), dtype=torch.bool, device="cuda")
        m[0] = False
        if label == "prefix":
            m[0, :13] = True
        elif label == "strided":
            m[0, ::9] = True
        masks[label] = m
    errs = {label: _check_fwd(A, f"stdit-xl2 cross {label}", q, k, v,
                              sm_scale=d ** -0.5, kv_valid=m)
            for label, m in masks.items()}
    qn, kn = _rand((b, sq, h, d), gen, True), _rand((b, sk, h, d), gen, True)
    _check_fwd(A, "stdit-xl2 cross strided, fixed max", qn, kn, v,
               sm_scale=d ** -0.5, kv_valid=masks["strided"], static_max=0.0)
    del qn, kn
    for static_max in (None, 0.0):
        out, lse = A.flash_fwd(q, k, v, sm_scale=d ** -0.5,
                               kv_valid=masks["empty row"],
                               static_max=static_max, emit_lse=True)
        if out[0].abs().max().item() != 0.0 \
                or not torch.isneginf(lse[0]).all().item():
            raise AssertionError("K4: a row with no valid key must give "
                                 "o = 0 and lse = -inf")
    m = masks["prefix"]
    n_valid = int(m.sum())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    io_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + m.numel()
    rec, backend = _time_record(A, q, k, v, (qt, kt, vt),
                                {"attn_mask": m[:, None, None, :]},
                                flops=4.0 * h * sq * n_valid * d,
                                io_bytes=io_bytes, sm_scale=d ** -0.5,
                                kv_valid=m)
    log("K4", case="stdit-xl2 cross timing (prefix mask)",
        kernel="flash_fwd_sm90 persistent, key mask",
        ms=f"{rec['ms']:.4f}", bound_ms=f"{rec['bound_ms']:.4f}",
        bound_by=rec["bound_by"], plain_ms=f"{rec['plain_ms']:.3f}",
        library=f"scaled_dot_product_attention[{backend}](attn_mask)",
        library_ms=f"{rec['library_ms']:.4f}", empty_row_zero=True)
    compare_designs(A, "stdit-xl2 cross, prefix mask", q, k, v, False, rec,
                    kv_valid=m)
    return dict(max_abs_err=errs["prefix"], **rec)


# ---------------------------------------------------------------- phase 6
def zero_counts(A) -> None:
    """Set every kernel's launch count to 0 just before a main-path run:
    per route, per Hopper design and of those at d = 128, and the
    alignment copies."""
    A.flash_fwd.launches = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5",
                                           "K6")}
    A.flash_bwd.launches = {"K7": 0, "K8": 0, "K9": 0, "K10": 0}
    A.flash_fwd.launches_sm90 = dict(A.flash_fwd.launches)
    A.flash_bwd.launches_sm90 = dict(A.flash_bwd.launches)
    A.flash_fwd.launches_d128 = dict(A.flash_fwd.launches)
    A.flash_bwd.launches_d128 = dict(A.flash_bwd.launches)
    A.flash_bwd.launches_rows = dict(A.flash_bwd.launches)
    A.flash_fwd.launches_f32 = dict(A.flash_fwd.launches)
    A.flash_fwd.launches_split = dict(A.flash_fwd.launches)
    A.flash_fwd.tma_copies = 0
    A.flash_bwd.tma_copies = 0


def read_counts(A) -> dict:
    """Every kernel's launch count, read just after a main-path run."""
    return dict(A.flash_fwd.launches, **A.flash_bwd.launches)


def read_sm90_counts(A) -> dict:
    """The Hopper designs' launches (flash_fwd_sm90 for K1-K6,
    flash_bwd_sm90 for K7 and K10 and for K8 and K9 at d = 128,
    flash_bwd_rows_sm90 for K8 and K9 at d = 72 and 80), of those the
    launches at d = 128 as ``<route>_d128`` (K3's kernel for K3 and K5,
    flash_bwd_sm90 for K8 and K9), the f32 design's (flash_fwd_f32_sm90)
    as ``<route>_f32``, the backward launches of flash_bwd_rows_sm90 as
    ``<route>_rows``, the forward launches whose plan split the keys as
    ``<route>_split``, and the alignment copies of the forward
    (``tma_copies``) and of the backward (``bwd_tma_copies``), read with
    ``read_counts``."""
    d128 = dict(A.flash_fwd.launches_d128, **A.flash_bwd.launches_d128)
    return dict(A.flash_fwd.launches_sm90, **A.flash_bwd.launches_sm90,
                **{f"{k}_d128": n for k, n in d128.items()},
                **{f"{k}_rows": n
                   for k, n in A.flash_bwd.launches_rows.items()},
                **{f"{k}_f32": n for k, n in A.flash_fwd.launches_f32.items()},
                **{f"{k}_split": n
                   for k, n in A.flash_fwd.launches_split.items()},
                tma_copies=A.flash_fwd.tma_copies,
                bwd_tma_copies=A.flash_bwd.tma_copies)


def check_split_counts(phase: str, sm90: dict, llama: int = 0,
                       clip: int = 0) -> None:
    """A main-path run's split launches: none but LLaMA's ``llama`` f32 K2
    and the CLIP image embedder's ``clip`` (every one on the f32 design,
    split, and none on flash_fwd.cu): the main paths' other shapes keep
    their unsplit plans."""
    split = {k[:-6]: n for k, n in sm90.items() if k.endswith("_split")}
    if split != dict({k: 0 for k in split}, K2=llama + clip) \
            or sm90["K2_f32"] != llama + clip:
        raise AssertionError(f"{phase}: split launches {split}, f32 K2 "
                             f"{sm90['K2_f32']}: expected {llama} LLaMA "
                             f"and {clip} CLIP launches on the split f32 "
                             "design and no other split")


def _read_video(path: str):
    import numpy as np
    if path.endswith(".npy"):
        return np.load(path)
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def run_e2e(A) -> dict:
    from videotuna_tpu_torch.cli.inference import run_inference
    savedir = os.path.join(OUT_DIR, "e2e")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    result = run_inference([
        "--config", CONFIG_5B, "--device", "cuda", "--quiet",
        "--savedir", savedir,
        "--prompt", "a panda playing guitar by a lake at sunset",
        f"flow.params.ddim_steps={E2E_STEPS}",
        f"flow.params.scheduler_config.params.num_steps={E2E_STEPS}",
        f"inference.decode_latent_frames={DECODE_LATENT_FRAMES}",
    ])
    launches = read_counts(A)
    sm90 = read_sm90_counts(A)
    m = result["metrics"]
    peak = torch.cuda.max_memory_allocated()
    expected = 42 * E2E_STEPS
    frames = 1 + 4 * (DECODE_LATENT_FRAMES - 1)
    video = _read_video(result["videos"][0])
    log("e2e", config="cogvideo5b", frames_sampled=49, height=480, width=720,
        steps=m["denoise_steps"], sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", decoded_frames=frames,
        peak_mem_gb=f"{peak / 1e9:.2f}", launches=launches,
        sm90_launches=sm90,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    if launches["K1"] != expected:
        raise AssertionError(f"K1 launched {launches['K1']} times, expected "
                             f"{expected} (42 layers × {E2E_STEPS} steps)")
    if sm90["K1"] != expected or sm90["tma_copies"]:
        raise AssertionError(f"{sm90}: every K1 launch must run "
                             f"flash_fwd_sm90 ({expected}), with no alignment "
                             "copy")
    check_split_counts("e2e", sm90)
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError("non-finite latents or pixels")
    if tuple(video.shape) != (frames, 480, 720, 3):
        raise AssertionError(f"video shape {video.shape}")
    if not os.path.isfile(os.path.join(savedir, "metric.json")):
        raise AssertionError("metric.json missing")
    return dict(launches=launches, sm90=sm90)


# ---------------------------------------------------------------- phase 7
@tf32_off()
def check_small_reference() -> None:
    """The narrow 5B-shaped flow on the card (K1) against the CPU (K1's
    plain version), same weights, same x_T and noise, TF32 off."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    cfg = load_configs([CONFIG_5B], [
        "flow.params.denoiser_config.params.dim=128",
        "flow.params.denoiser_config.params.heads=2",
        "flow.params.denoiser_config.params.num_layers=2",
        "flow.params.denoiser_config.params.text_dim=64",
        "flow.params.cond_stage_config.params.dim=64",
        "flow.params.cond_stage_config.params.heads=2",
        "flow.params.cond_stage_config.params.head_dim=32",
        "flow.params.cond_stage_config.params.ff_dim=128",
        "flow.params.cond_stage_config.params.num_layers=2",
        "flow.params.first_stage_config.params.ch=32",
        "flow.params.first_stage_config.params.num_res_blocks=1",
        f"flow.params.ddim_steps={E2E_STEPS}",
        f"flow.params.scheduler_config.params.num_steps={E2E_STEPS}",
    ])
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    shape = cpu.latent_shape(1, 9, 96, 128)       # 3×12×16 → 144 + 226 tokens
    gen = torch.Generator().manual_seed(2)
    x_T = torch.randn(shape, generator=gen)
    noises = torch.randn((E2E_STEPS, *shape), generator=gen)
    t = torch.tensor([cpu.scheduler.timesteps[1].item()])
    outs = []
    z_cpu = None
    for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
        cond = flow.encode_text(["a panda playing guitar"])
        uncond = flow.encode_text([""])
        with torch.inference_mode():
            call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
        z = flow.sample(cond, uncond, shape, None, 6.0, x_T=x_T.to(dev),
                        noises=noises.to(dev))
        z_cpu = z if z_cpu is None else z_cpu
        # decode the CPU's latents on both: the VAE alone, in f32
        video = flow.decode_latents(z_cpu.to(dev))
        outs.append([x.float().cpu() for x in (call, z, video)])

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    tols = (REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE)
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log("reference", what="narrow cogvideo5b flow, cuda vs cpu",
        denoiser_call_rel_err=f"{errs[0]:.3e}", call_tol=REF_TOL_CALL,
        latent_rel_err=f"{errs[1]:.3e}", latent_tol=REF_TOL_TRAJ,
        decode_rel_err=f"{errs[2]:.3e}", decode_tol=REF_TOL_DECODE, ok=ok)
    if not ok:
        raise AssertionError("GPU flow disagrees with the CPU flow")


# ---------------------------------------------------------------- phase 8
def run_e2e_opensora(A) -> dict:
    from videotuna_tpu_torch.cli.inference import run_inference
    savedir = os.path.join(OUT_DIR, "e2e_opensora")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    result = run_inference([
        "--config", CONFIG_OS, "--device", "cuda", "--quiet",
        "--savedir", savedir,
        "--prompt", "a panda playing guitar by a lake at sunset",
        f"flow.params.ddim_steps={OS_STEPS}",
    ])
    launches = read_counts(A)
    sm90 = read_sm90_counts(A)
    m = result["metrics"]
    peak = torch.cuda.max_memory_allocated()
    video = _read_video(result["videos"][0])
    log("e2e-opensora", config="opensorav10_256x256", frames=16, height=256,
        width=256, steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.4f}",
        sample_sec=f"{m['sample_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", launches=launches,
        sm90_launches=sm90,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    expected = OS_DEPTH * OS_STEPS
    if m["denoise_steps"] != OS_STEPS or launches["K2"] != expected \
            or launches["K4"] != expected or launches["K1"] != 0:
        raise AssertionError(f"launches {launches}, expected K2 = K4 = "
                             f"{expected} ({OS_DEPTH} layers × {OS_STEPS} "
                             "steps) and no K1")
    check_split_counts("e2e-opensora", sm90)
    if sm90["K2"] != expected or sm90["K4"] != expected \
            or sm90["tma_copies"]:
        raise AssertionError(f"{sm90}: every K2 and K4 launch must run "
                             f"flash_fwd_sm90 ({expected} each: {OS_DEPTH} a "
                             "step, none on flash_fwd.cu), with no alignment "
                             "copy")
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError("non-finite latents or pixels")
    if tuple(video.shape) != (16, 256, 256, 3):
        raise AssertionError(f"video shape {video.shape}")
    if not os.path.isfile(os.path.join(savedir, "metric.json")):
        raise AssertionError("metric.json missing")
    return dict(launches=launches, sm90=sm90)


# ---------------------------------------------------------------- phase 9
@tf32_off()
def check_small_reference_opensora() -> None:
    """The narrow Open-Sora flow on the card (K2, K4) against the CPU (their
    plain versions), same weights, x_T, prompt and latents, TF32 off."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    den = "flow.params.denoiser_config.params"
    t5 = "flow.params.cond_stage_config.params"
    cfg = load_configs([CONFIG_OS], [
        f"{den}.hidden_size=144", f"{den}.num_heads=2", f"{den}.depth=2",
        f"{den}.caption_channels=64",
        f"{t5}.dim=64", f"{t5}.heads=2", f"{t5}.head_dim=32",
        f"{t5}.ff_dim=128", f"{t5}.num_layers=2",
        "flow.params.first_stage_config.params.ch=32",
        "flow.params.first_stage_config.params.num_res_blocks=1",
        f"flow.params.ddim_steps={OS_REF_STEPS}",
    ])
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    shape = cpu.latent_shape(1, 4, 256, 256)      # 4×32×32 latents
    gen = torch.Generator().manual_seed(2)
    x_T = torch.randn(shape, generator=gen)
    t = torch.tensor([int(cpu.scheduler.timesteps[-2])])
    import videotuna_tpu_torch.kernels.attention as A
    outs, z_cpu = [], None
    for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
        zero_counts(A)
        cond = flow.encode_text(["a panda playing guitar by a lake"])
        uncond = flow.encode_text([""])
        with torch.inference_mode():
            call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
        z = flow.sample(cond, uncond, shape, None, 7.0, x_T=x_T.to(dev))
        launches = {k: v for k, v in read_counts(A).items() if v}
        z_cpu = z if z_cpu is None else z_cpu
        video = flow.decode_latents(z_cpu.to(dev))
        decode_launches = {k: v for k, v in read_counts(A).items() if v}
        outs.append([x.float().cpu() for x in (call, z, video)])
    expected = 2 * (1 + OS_REF_STEPS)     # depth 2 × (one call + the steps)
    if launches != {"K2": expected, "K4": expected}:
        raise AssertionError(f"narrow Open-Sora flow on the card launched "
                             f"{launches}, expected {expected} of each")
    # the decoder's f32 mid attention (one head of d=128 over 32×32 tokens)
    # takes flash_fwd's f32 path once
    if decode_launches != {"K2": expected + 1, "K4": expected}:
        raise AssertionError(f"narrow Open-Sora decode launched "
                             f"{decode_launches}, expected one more K2")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    tols = (REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE)
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log("reference-opensora", what="narrow opensorav10 flow, cuda vs cpu",
        steps=OS_REF_STEPS, card_launches=launches,
        decode_f32_k2=decode_launches["K2"] - launches["K2"],
        denoiser_call_rel_err=f"{errs[0]:.3e}", call_tol=REF_TOL_CALL,
        latent_rel_err=f"{errs[1]:.3e}", latent_tol=REF_TOL_TRAJ,
        decode_rel_err=f"{errs[2]:.3e}", decode_tol=REF_TOL_DECODE, ok=ok)
    if not ok:
        raise AssertionError("GPU Open-Sora flow disagrees with the CPU flow")


# ---------------------------------------------------------------- phase 10
def profile_opensora_call() -> dict:
    """One STDiT-XL/2 denoiser call with CFG (B=2, 16×32×32 latents, a
    120-token caption with a ragged mask), the work of one sampling step,
    timed with CUDA events and traced with torch.profiler: device time by
    kernel group, and the device's busy share of the call."""
    from torch.profiler import ProfilerActivity, profile
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    cfg = load_configs([CONFIG_OS])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 16, 32, 32, 4), generator=gen, device="cuda")
    t = torch.tensor([500, 500], device="cuda")
    y = torch.randn((2, 120, 4096), generator=gen, device="cuda")
    mask = torch.ones((2, 120), dtype=torch.bool, device="cuda")
    mask[0, 13:] = False
    with torch.inference_mode():
        call_ms = cuda_time_ms(lambda: model(x, t, y, mask), reps=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x, t, y, mask)
            torch.cuda.synchronize()
    del model
    return _log_profile("profile-opensora", "one STDiT-XL/2 call, CFG batch 2",
                        prof, call_ms, "flash_fwd (K2+K4)")


def _log_profile(phase: str, what: str, prof, call_ms: float,
                 flash: str, extra_groups=()) -> dict:
    """Device time of a traced call by kernel group (the flash kernel,
    ``extra_groups`` ((name, substrings), matched first), GEMMs, everything
    else), its busy share of ``call_ms`` and the 8 longest kernels."""
    groups = {flash: 0.0, **{g: 0.0 for g, _ in extra_groups}, "gemm": 0.0,
              "other": 0.0}
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        kernels[e.key] = us / 1e3
        name = e.key.lower()
        extra = [g for g, keys in extra_groups
                 if any(k in name for k in keys)]
        group = (flash if "flash_fwd" in name else
                 extra[0] if extra else
                 "gemm" if any(g in name for g in ("gemm", "nvjet", "xmma",
                                                   "cutlass", "cublas"))
                 else "other")
        groups[group] += us / 1e3
    device_ms = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(phase, what=what, call_ms=f"{call_ms:.3f}",
        device_ms=f"{device_ms:.3f}" if device_ms else "not measured",
        busy_share=(f"{device_ms / call_ms:.3f}" if device_ms
                    else "not measured"),
        **{k.replace(" ", "_"): f"{v:.3f}" for k, v in groups.items()})
    for name, ms in top:
        log(phase, kernel=name[:90].replace(" ", ""), ms=f"{ms:.3f}",
            share=f"{ms / call_ms:.3f}")
    return groups


# ---------------------------------------------------------------- phase 11
def _bwd_plain_chunked(A, q, k, v, out, g, lse, sm_scale, rows=256):
    """The plain backward (non-causal) over all query rows, a block of rows
    at a time in f32 (the whole score tensor would not fit): dq of each
    block, dk and dv summed over the blocks."""
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(0, q.shape[1], rows):
        sl = slice(i, i + rows)
        a, b, c = A.flash_bwd_plain(q[:, sl].float(), kf, vf,
                                    out[:, sl].float(), g[:, sl].float(),
                                    lse[:, :, sl], sm_scale=sm_scale)
        dq[:, sl] = a
        dk += b
        dv += c
    return dq, dk, dv


def _bwd_errs(got, ref):
    """(max|err| over dq, dk, dv; whether each output is finite and within
    BWD_TOL of its own max|ref|; the per-output errors and tolerances)."""
    ok, rows = True, []
    for x, r in zip(got, ref):
        err = (x.float() - r.float()).abs().max().item()
        tol = BWD_TOL * r.float().abs().max().item()
        ok = ok and bool(torch.isfinite(x.float()).all()) and err <= tol
        rows.append(f"{err:.3e}/{tol:.3e}")
    return max(float(r.split("/")[0]) for r in rows), ok, rows


def sdpa_bwd_ms(q, k, v, g, reps: int, attn_mask=None):
    """Backward time of torch's scaled_dot_product_attention on the same
    tensors, a yardstick only (the port never calls it): forward plus
    backward minus forward, for the fastest backend that takes the inputs,
    and that backend's name."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    kw = {} if attn_mask is None else {"attn_mask": attn_mask}

    def fwd():
        return sdpa(qt, kt, vt, **kw)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), gt)

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fwd_bwd()
                torch.cuda.synchronize()
                times[backend.name] = (cuda_time_ms(fwd_bwd, reps)
                                       - cuda_time_ms(fwd, reps))
        except RuntimeError:   # this backend does not take the inputs
            continue
    log("sdpa-bwd", **{k: f"{v:.4f}" for k, v in times.items()})
    best = min(times, key=times.get)
    return times[best], best


def sdpa_bwd_device_ms(q, k, v, g, reps: int, attn_mask=None):
    """Device time of torch's scaled_dot_product_attention backward on the
    same tensors, a yardstick only: forward plus backward minus forward,
    each captured in a CUDA graph (``device_ms``), for the fastest backend
    that takes the inputs, and that backend's name."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from videotuna_tpu_torch.kernels.attribution import device_ms
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    kw = {} if attn_mask is None else {"attn_mask": attn_mask}
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                times[backend.name] = (
                    device_ms(lambda: torch.autograd.grad(
                        sdpa(qt, kt, vt, **kw), (qt, kt, vt), gt), reps)
                    - device_ms(lambda: sdpa(qt, kt, vt, **kw), reps))
        except RuntimeError:   # this backend does not take the inputs
            continue
    log("sdpa-bwd", timer="device (CUDA graph)",
        **{k: f"{v:.4f}" for k, v in times.items()})
    best = min(times, key=times.get)
    return times[best], best


def time_k8(A, label, q, k, v, out, g, lse, kv_valid, rec) -> None:
    """K8 on the short-row Hopper kernel (flash_bwd_rows_sm90.cu) beside the
    old two-pass design (flash_bwd.cu, ``_flash_bwd_mma``) on the same
    tensors, by CUDA events around 50 calls and by device time (50 calls in
    a CUDA graph), with each wrapper's host time per call, and SDPA's
    backward by both timers; into ``rec``.  The masked call reads the mask
    words a training forward packs (``_pack_mask_words``), as on the main
    path."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    sm = q.shape[-1] ** -0.5
    words = (A._pack_mask_words(kv_valid, q.shape[0], k.shape[1])
             if kv_valid is not None else None)
    new = lambda: A.flash_bwd(q, k, v, out, g, lse, sm_scale=sm,
                              kv_valid=kv_valid, mask_words=words)
    old = lambda: A._flash_bwd_mma(q, k, v, out, g, lse, sm, False,
                                   kv_valid)
    mask = None if kv_valid is None else kv_valid[:, None, None, :]
    rec.update(
        ms=cuda_time_ms(new, reps=50), old_design_ms=cuda_time_ms(old, 50),
        device_ms=device_ms(new, reps=50),
        old_design_device_ms=device_ms(old, reps=50),
        host_ms=host_ms(new, 200), old_design_host_ms=host_ms(old, 200))
    rec["library_ms"], backend = sdpa_bwd_ms(q, k, v, g, reps=20,
                                             attn_mask=mask)
    rec["library_device_ms"], dev_backend = sdpa_bwd_device_ms(
        q, k, v, g, reps=20, attn_mask=mask)
    log("K8", case=label, compare="flash_bwd_rows_sm90 (Hopper, single "
        "pass) vs flash_bwd.cu (two-pass mma.sync) vs sdpa backward",
        ms=f"{rec['ms']:.4f}", device_ms=f"{rec['device_ms']:.4f}",
        host_ms=f"{rec['host_ms']:.4f}",
        old_design_ms=f"{rec['old_design_ms']:.4f}",
        old_design_device_ms=f"{rec['old_design_device_ms']:.4f}",
        old_design_host_ms=f"{rec['old_design_host_ms']:.4f}",
        library=f"sdpa backward[{backend}], device [{dev_backend}]",
        library_ms=f"{rec['library_ms']:.4f}",
        library_device_ms=f"{rec['library_device_ms']:.4f}",
        bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"],
        faster=rec["device_ms"] < rec["old_design_device_ms"])
    if not rec["device_ms"] < rec["old_design_device_ms"]:
        raise AssertionError(f"K8 ({label}): flash_bwd_rows_sm90 is not "
                             "faster than flash_bwd.cu by device time")


def _check_bwd_case(A, label, route, q, k, v, g, single_pass=True,
                    chunked=False, **kw):
    """flash_bwd against flash_bwd_plain on the forward's own output and
    LSE; returns (max|err|, o, lse, reference, plain ms)."""
    sm_scale = q.shape[-1] ** -0.5
    out, lse = A.flash_fwd(q, k, v, sm_scale=sm_scale, emit_lse=True, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if chunked:
        ref = _bwd_plain_chunked(A, q, k, v, out, g, lse, sm_scale)
    else:
        ref = A.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                g.float(), lse, sm_scale=sm_scale, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    before = (dict(A.flash_bwd.launches), dict(A.flash_bwd.launches_sm90))
    design = A._bwd_design(route, q.dtype, q.shape[-1],
                           kw.get("causal", False),
                           kw.get("kv_valid") is not None)
    got = A.flash_bwd(q, k, v, out, g, lse, sm_scale=sm_scale,
                      single_pass=single_pass, **kw)
    torch.cuda.synchronize()
    err, ok, rows = _bwd_errs(got, ref)
    ok = ok and A.flash_bwd.launches == dict(
        before[0], **{route: before[0][route] + 1}) \
        and A.flash_bwd.launches_sm90 == dict(
            before[1], **{route: before[1][route] + (design == "sm90")})
    b, sq, h, d = q.shape
    kernel = {"mma": "flash_bwd", "sm90": {
        "sm90": "flash_bwd_sm90", "rows": "flash_bwd_rows_sm90"}[
        A._bwd_kernel(d, k.shape[1])]}[design]
    log(route, case=label, shape=f"B{b}xSq{sq}xSk{k.shape[1]}xH{h}xd{d}",
        kernel=kernel, causal=kw.get("causal", False),
        single_pass=single_pass, dq=rows[0], dk=rows[1], dv=rows[2], ok=ok)
    if not ok:
        raise AssertionError(f"{route} disagrees with the plain backward "
                             f"({label})")
    return err, out, lse, ref, plain_ms, got


def check_bwd(A) -> dict:
    """K7, K8 (and K9, K10 through single_pass=False) against the plain
    backward at the shapes of both training runs and at ragged, causal and
    masked shapes; gradients through the custom VJPs against autograd of
    the plain math.  Timed beside the bound, the plain version and SDPA's
    backward."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rec = {}

    # K7: CogVideoX-2B training, B=1, S=17776, H=30, d=64; the LSE from K1
    # under the fixed max M=0 (the flow's mode) and online
    b, s, h = SHAPE_2B["b"], SHAPE_2B["s"], SHAPE_2B["h"]
    q, k, v = _qkv(b, s, s, h, gen)
    g = _rand((b, s, h, 64), gen)
    out, lse = _k1(A, q, k, v, 0.0, emit_lse=True)
    torch.cuda.synchronize()
    # K1 itself at the training shape, fixed max with the LSE: the
    # persistent kernel beside flash_fwd.cu and SDPA on the same tensors
    k1_ms = cuda_time_ms(lambda: _k1(A, q, k, v, 0.0, emit_lse=True), reps=5)
    k1_old_ms = cuda_time_ms(lambda: A._flash_fwd_mma(
        q, k, v, 0.125, False, None, 0.0, True), reps=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    k1_lib_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=5)
    del qt, kt, vt
    k1_exp2 = _exp2_floor_ms(b * h * s * s)
    k1_bound, k1_by = _bound(4.0 * b * h * s * s * 64,
                             4 * q.numel() * q.element_size() + b * h * s * 4,
                             k1_exp2)
    rec["K1_train"] = dict(ms=k1_ms, old_design_ms=k1_old_ms,
                           library_ms=k1_lib_ms, bound_ms=k1_bound)
    log("K1", case="cogvideox-2b training forward, static_max=0, emit_lse",
        shape=f"B{b}xS{s}xH{h}xd64", kernel="flash_fwd_sm90 persistent",
        ms=f"{k1_ms:.3f}", old_design_ms=f"{k1_old_ms:.3f}",
        bound_ms=f"{k1_bound:.3f}", bound_by=k1_by,
        exp2_floor_ms=f"{k1_exp2:.3f}",
        ns_per_mscore=f"{k1_ms * 1e6 / (b * h * s * s / 1e6):.3f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{k1_lib_ms:.3f}")
    t0 = time.perf_counter()
    ref = _bwd_plain_chunked(A, q, k, v, out, g, lse, 0.125)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for mode in ("static_max=0", "online"):
        if mode == "online":
            out, lse = _k1(A, q, k, v, None, emit_lse=True)
        for route, single_pass in (("K7", True), ("K10", False)):
            before = (dict(A.flash_bwd.launches),
                      dict(A.flash_bwd.launches_sm90))
            got = A.flash_bwd(q, k, v, out, g, lse, sm_scale=0.125,
                              single_pass=single_pass)
            torch.cuda.synchronize()
            err, ok, rows = _bwd_errs(got, ref)
            ok = ok and all(c == dict(b4, **{route: b4[route] + 1}) for c, b4
                            in zip((A.flash_bwd.launches,
                                    A.flash_bwd.launches_sm90), before))
            log(route, forward=f"K1 {mode}", shape=f"B{b}xS{s}xH{h}xd64",
                kernel="flash_bwd_sm90", dq=rows[0], dk=rows[1], dv=rows[2],
                ok=ok)
            if not ok:
                raise AssertionError(f"{route} disagrees with the plain "
                                     f"backward at the 2B shape ({mode}), "
                                     "or did not launch flash_bwd_sm90")
            rec.setdefault(route, {"max_abs_err": err})
            del got
        if mode == "static_max=0":
            # the old two-pass design (flash_bwd.cu), K7's and K10's A/B
            # baseline, on the same tensors
            got = A._flash_bwd_mma(q, k, v, out, g, lse, 0.125)
            torch.cuda.synchronize()
            _, old_ok, rows = _bwd_errs(got, ref)
            log("K7", compare="flash_bwd.cu (two-pass mma.sync, the A/B "
                "baseline) at the 2B shape", dq=rows[0], dk=rows[1],
                dv=rows[2], ok=old_ok)
            if not old_ok:
                raise AssertionError("flash_bwd.cu disagrees with the plain "
                                     "backward at the 2B shape")
            del got
    flops = 10.0 * b * h * s * s * 64
    io = 8 * q.numel() * q.element_size() + lse.numel() * 4
    bound_ms, bound_by = _bound(flops, io)
    library_ms, backend = sdpa_bwd_ms(q, k, v, g, reps=3)
    old_ms = cuda_time_ms(lambda: A._flash_bwd_mma(q, k, v, out, g, lse,
                                                   0.125), reps=3)
    for route, single_pass in (("K7", True), ("K10", False)):
        ms = cuda_time_ms(lambda: A.flash_bwd(
            q, k, v, out, g, lse, sm_scale=0.125, single_pass=single_pass),
            reps=3)
        rec[route].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms,
                          old_design_ms=old_ms)
        log(route, case="cogvideox-2b timing", kernel="flash_bwd_sm90",
            ms=f"{ms:.3f}", bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
            plain_ms=f"{plain_ms:.1f}", tflops=f"{flops / ms / 1e9:.1f}",
            library=f"sdpa backward[{backend}]",
            library_ms=f"{library_ms:.3f}")
    log("K7", compare="flash_bwd.cu (the two-pass mma.sync design) on the "
        "same tensors", ms=f"{old_ms:.3f}", sm90_ms=f"{rec['K7']['ms']:.3f}",
        faster=rec["K7"]["ms"] < old_ms)
    if not rec["K7"]["ms"] < old_ms:
        raise AssertionError("flash_bwd_sm90 is not faster than flash_bwd "
                             "at the CogVideoX-2B shape")
    del q, k, v, g, out, lse, ref

    # K8 (and K9), K5: STDiT-XL/2 spatial self-attention, batch 1 × 16
    # frames: B=16, S=256, H=16, d=72
    b, s, h, d = 16, 256, 16, 72
    q, k, v, g = (_rand((b, s, h, d), gen) for _ in range(4))
    err, out, lse, ref, plain_ms, _ = _check_bwd_case(
        A, "stdit-xl2 spatial", "K8", q, k, v, g)
    err9 = _check_bwd_case(A, "stdit-xl2 spatial", "K9", q, k, v, g,
                           single_pass=False)[0]
    io = 8 * q.numel() * q.element_size() + lse.numel() * 4
    bound_ms, bound_by = _bound(10.0 * b * h * s * s * d, io)
    rec["K8"] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)
    time_k8(A, "stdit-xl2 spatial", q, k, v, out, g, lse, None, rec["K8"])
    ms9 = cuda_time_ms(lambda: A.flash_bwd(
        q, k, v, out, g, lse, sm_scale=d ** -0.5, single_pass=False),
        reps=50)
    rec["K9"] = dict(max_abs_err=err9, ms=ms9, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=rec["K8"]["library_ms"],
                     old_design_ms=rec["K8"]["old_design_ms"])
    log("K9", case="stdit-xl2 spatial timing", kernel="flash_bwd_rows_sm90",
        ms=f"{ms9:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        plain_ms=f"{plain_ms:.3f}")
    # K5: the training forward (flash_fwd with the LSE) at the same shape
    before = (A.flash_fwd.launches["K5"], A.flash_fwd.launches_sm90["K5"])
    o5, lse5 = A.flash_fwd(q, k, v, sm_scale=d ** -0.5, emit_lse=True,
                           route="K5")
    r5, rl5 = A.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5, emit_lse=True)
    torch.cuda.synchronize()
    err5 = (o5.float() - r5.float()).abs().max().item()
    lse_err5 = (lse5 - rl5).abs().max().item()
    ok = (err5 <= FWD_TOL * r5.float().abs().max().item()
          and lse_err5 <= LSE_TOL
          and (A.flash_fwd.launches["K5"], A.flash_fwd.launches_sm90["K5"])
          == (before[0] + 1, before[1] + 1))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bound_ms, bound_by = _bound(
        4.0 * b * h * s * s * d,
        4 * q.numel() * q.element_size() + lse5.numel() * 4)
    library_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=50)
    k5 = dict(
        ms=cuda_time_ms(lambda: A.flash_fwd(q, k, v, sm_scale=d ** -0.5,
                                            emit_lse=True, route="K5"),
                        reps=50),
        plain_ms=cuda_time_ms(lambda: A.flash_fwd_plain(
            q, k, v, sm_scale=d ** -0.5, emit_lse=True), reps=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    rec["K5"] = dict(max_abs_err=err5, **k5)
    log("K5", case="stdit-xl2 spatial, emit_lse", kernel="flash_fwd_sm90",
        max_abs_err=f"{err5:.3e}",
        lse_err=f"{lse_err5:.3e}", ms=f"{k5['ms']:.4f}",
        bound_ms=f"{k5['bound_ms']:.4f}", bound_by=k5["bound_by"],
        plain_ms=f"{k5['plain_ms']:.3f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{k5['library_ms']:.4f}", ok=ok)
    if not ok:
        raise AssertionError("K5 (flash_fwd with the LSE) disagrees with "
                             "its plain version, or did not launch "
                             "flash_fwd_sm90")
    compare_designs(A, "stdit-xl2 spatial, emit_lse", q, k, v, True,
                    rec["K5"])
    del q, k, v, g, out, lse, ref, qt, kt, vt

    # K8 with the key mask: STDiT-XL/2 cross-attention, 4096 queries over
    # the 120-token caption; B=1 with 13 valid keys (timed), then B=2 with a
    # strided row and a row with no valid key (zeros, no NaN)
    sq, sk, h, d = 4096, 120, 16, 72
    q, g = (_rand((2, sq, h, d), gen) for _ in range(2))
    k, v = (_rand((2, sk, h, d), gen) for _ in range(2))
    m = torch.zeros((2, sk), dtype=torch.bool, device="cuda")
    m[0, ::9] = True
    dq, dk, dv = _check_bwd_case(A, "stdit-xl2 cross, empty row", "K8",
                                 q, k, v, g, kv_valid=m)[-1]
    if dq[1].abs().max().item() != 0 or dk[0, ~m[0]].abs().max().item() \
            or dv[0, ~m[0]].abs().max().item():
        raise AssertionError("masked backward: a row with no valid key must "
                             "give dq = 0, a masked key dk = dv = 0")
    q1, k1, v1, g1 = (x[:1].contiguous() for x in (q, k, v, g))
    m1 = torch.zeros((1, sk), dtype=torch.bool, device="cuda")
    m1[0, :13] = True
    err, out, lse, _, plain_ms, _ = _check_bwd_case(
        A, "stdit-xl2 cross, 13 of 120 keys", "K8", q1, k1, v1, g1,
        kv_valid=m1)
    io = (4 * q1.numel() + 4 * k1.numel()) * q1.element_size() \
        + lse.numel() * 4 + m1.numel() // 8
    bound_ms, bound_by = _bound(10.0 * h * sq * 13 * d, io)
    cross = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
    time_k8(A, "stdit-xl2 cross, 13 of 120 keys", q1, k1, v1, out, g1, lse,
            m1, cross)
    rec["K8"].update({f"cross_{key}": val for key, val in cross.items()})
    del q, k, v, g, q1, k1, v1, g1, out, lse

    # ragged, causal and narrow widths; d = 160 and 256 (columns split
    # between two blocks), causal and masked
    for label, (bb, sq, sk, hh, dd, causal, masked) in {
            "d64 causal": (2, 333, 333, 2, 64, True, False),
            "d128 ragged long": (1, 300, 4322, 2, 128, False, False),
            "d128 masked": (1, 300, 4322, 2, 128, False, True),
            "d32 causal ragged edge": (1, 130, 300, 2, 32, True, False),
            "d256 causal": (2, 300, 300, 3, 256, True, False),
            "d256 masked": (2, 300, 300, 3, 256, False, True),
            "d160 causal": (2, 300, 300, 3, 160, True, False),
            "d160 masked": (2, 300, 300, 3, 160, False, True)}.items():
        qq, gg = (_rand((bb, sq, hh, dd), gen) for _ in range(2))
        kk, vv = (_rand((bb, sk, hh, dd), gen) for _ in range(2))
        kw = {"causal": causal}
        if masked:   # row 0 keeps 37 keys
            kw["kv_valid"] = torch.ones((bb, sk), dtype=torch.bool,
                                        device="cuda")
            kw["kv_valid"][0, 37:] = False
        _, oo, ll, *_ = _check_bwd_case(A, label, "K8", qq, kk, vv, gg, **kw)
        if dd == 256 and causal:
            ms = cuda_time_ms(lambda: A.flash_bwd(
                qq, kk, vv, oo, gg, ll, sm_scale=dd ** -0.5, causal=True),
                reps=20)
            log("K8", case="d256 causal timing",
                shape=f"B{bb}xS{sq}xH{hh}xd{dd}", ms=f"{ms:.4f}")

    # gradients through the custom VJPs (dot_product_attention under
    # autograd, and flash_attention_diff with single_pass=False) against
    # autograd of the plain math in f32
    for label, (dd, sk, masked, single_pass, route) in {
            "d64 K1+K7": (64, 512, False, True, "K7"),
            "d64 K1+K10": (64, 512, False, False, "K10"),
            "d72 K5+K9": (72, 512, False, False, "K9"),
            "d72 masked K4+K8": (72, 120, True, True, "K8")}.items():
        base = [_rand((2, 512, 2, dd), gen)] + \
            [_rand((2, sk, 2, dd), gen) for _ in range(2)]
        gg = _rand((2, 512, 2, dd), gen)
        mask = None
        if masked:
            mask = torch.ones((2, sk), dtype=torch.bool, device="cuda")
            mask[0, 30:] = False
        x = [t.clone().requires_grad_() for t in base]
        before = dict(A.flash_bwd.launches)
        if single_pass:
            o = A.dot_product_attention(*x, kv_valid=mask)
        else:
            o = A.flash_attention_diff(*x, single_pass=False)
        o.backward(gg)
        r = [t.float().requires_grad_() for t in base]
        bias = None if mask is None else \
            torch.where(mask, 0.0, -1e30)[:, None, None, :]
        A.reference_attention(*r, bias=bias).backward(gg.float())
        torch.cuda.synchronize()
        err, ok, rows = _bwd_errs([t.grad for t in x], [t.grad for t in r])
        ok = ok and A.flash_bwd.launches == dict(
            before, **{route: before[route] + 1})
        log("vjp", case=label, dq=rows[0], dk=rows[1], dv=rows[2], ok=ok)
        if not ok:
            raise AssertionError(f"gradients through the custom VJP "
                                 f"disagree with autograd ({label})")
    check_bwd_hunyuan(A, gen, rec)
    return rec


def check_bwd_hunyuan(A, gen, rec) -> None:
    """HunyuanVideo's training attention (B=1, the LoRA run's tokens, H=24,
    d=128, bf16, RMSNormed q and k) under the fixed max 0
    (``_train_attention``).  Into ``rec["K5"]`` and ``rec["K8"]`` as
    ``d128_*``."""
    k5, k8 = _train_attention(A, gen, HY_TRAIN_TOKENS, 0.0, "hunyuan")
    rec["K5"].update({f"d128_{key}": val for key, val in k5.items()})
    rec["K8"].update({f"d128_{key}": val for key, val in k8.items()})


def _train_attention(A, gen, s, static_max, what, phase=None,
                     device=False):
    """A training step's joint attention at d=128 (B=1, ``s`` tokens, H=24,
    bf16, RMSNormed q and k): K5, the forward with the LSE under the fixed
    max ``static_max`` or online (None), on K3's Hopper kernel, against the
    plain chunked forward; K8, unmasked, on that forward's output and LSE,
    on flash_bwd_sm90 at its width 128, against the plain chunked backward.
    Each counted per route, per design and at d=128, and timed beside the
    bound (the online forward's with its exp2 floor), the plain version,
    SDPA (forward; backward as forward plus backward minus forward) and
    the old design on the same tensors (flash_fwd.cu, flash_bwd.cu); with
    ``device`` also by device time.  Logged under ``phase`` (else "K5" and
    "K8"); returns their records."""
    b, h, d = 1, SHAPE_HY["h"], 128
    sm = d ** -0.5
    q, k = (_rms(torch.randn((b, s, h, d), generator=gen,
                             device="cuda")).bfloat16() for _ in range(2))
    v, g = (torch.randn((b, s, h, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    shape = f"B{b}xS{s}xH{h}xd{d}"

    def fwd():
        return A.flash_fwd(q, k, v, sm_scale=sm, static_max=static_max,
                           emit_lse=True, route="K5")

    def fwd_counts():
        return (A.flash_fwd.launches["K5"], A.flash_fwd.launches_sm90["K5"],
                A.flash_fwd.launches_d128["K5"])

    counts = fwd_counts()
    out, lse = fwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_lse = _plain_chunked(A, q, k, v, static_max)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out.float() - ref.float()).abs().max().item()
    tol = FWD_TOL * ref.float().abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (err <= tol and lse_err <= LSE_TOL
          and fwd_counts() == tuple(n + 1 for n in counts))
    del ref, ref_lse
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=10)
    flops = 4.0 * b * h * s * s * d
    bound_ms, bound_by = _bound(
        flops, 4 * q.numel() * q.element_size() + lse.numel() * 4,
        _exp2_floor_ms(h * s * s) if static_max is None else 0.0)

    def old():
        return A._flash_fwd_mma(q, k, v, sm, False, None, static_max, True)

    ms = cuda_time_ms(fwd, reps=10)
    old_ms = cuda_time_ms(old, reps=10)
    k5 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=library_ms, old_design_ms=old_ms)
    if device:
        from videotuna_tpu_torch.kernels.attribution import device_ms
        dev = [device_ms(fn, reps=5) for fn in (fwd, old, old, fwd)]
        k5.update(device_ms=min(dev[0], dev[3]),
                  old_design_device_ms=min(dev[1], dev[2]),
                  library_device_ms=sdpa_device_ms((qt, kt, vt), {},
                                                   reps=5)[0])
    del qt, kt, vt
    softmax = ("online" if static_max is None
               else f"static_max={static_max:g}")
    log(phase or "K5", case=f"{what} training joint, {softmax}, emit_lse",
        shape=shape, kernel="flash_fwd_sm90 (K3's kernel with the LSE)",
        max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
        lse_err=f"{lse_err:.3e}", lse_tol=LSE_TOL,
        ms=f"{ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}",
        bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        plain_ms=f"{plain_ms:.1f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{library_ms:.3f}",
        old_design="flash_fwd.cu", old_design_ms=f"{old_ms:.3f}",
        old_tflops=f"{flops / old_ms / 1e9:.1f}",
        **{key: f"{k5[key]:.4f}" for key in ("device_ms",
                                             "old_design_device_ms",
                                             "library_device_ms")
           if key in k5}, ok=ok)
    if not ok:
        raise AssertionError(f"K5 at {what}'s training shape disagrees "
                             "with its plain version, or did not launch "
                             "flash_fwd_sm90 at d=128")

    def bwd():
        return A.flash_bwd(q, k, v, out, g, lse, sm_scale=sm)

    def bwd_counts():
        return (A.flash_bwd.launches["K8"], A.flash_bwd.launches_sm90["K8"],
                A.flash_bwd.launches_d128["K8"])

    counts = bwd_counts()
    got = bwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = _bwd_plain_chunked(A, q, k, v, out, g, lse, sm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, ok, rows = _bwd_errs(got, ref)
    ok = ok and bwd_counts() == tuple(n + 1 for n in counts)
    _, old_ok, old_rows = _bwd_errs(
        A._flash_bwd_mma(q, k, v, out, g, lse, sm), ref)
    del got, ref
    flops = 10.0 * b * h * s * s * d
    bound_ms, bound_by = _bound(flops, 8 * q.numel() * q.element_size()
                                + lse.numel() * 4)
    def old_bwd():
        return A._flash_bwd_mma(q, k, v, out, g, lse, sm)

    ms = cuda_time_ms(bwd, reps=5)
    old_ms = cuda_time_ms(old_bwd, reps=5)
    library_ms, backend = sdpa_bwd_ms(q, k, v, g, reps=5)
    k8 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=library_ms, old_design_ms=old_ms)
    if device:
        dev = [device_ms(fn, reps=3) for fn in (bwd, old_bwd, old_bwd, bwd)]
        k8.update(device_ms=min(dev[0], dev[3]),
                  old_design_device_ms=min(dev[1], dev[2]),
                  library_device_ms=sdpa_bwd_device_ms(q, k, v, g,
                                                       reps=3)[0])
    log(phase or "K8", case=f"{what} training joint, unmasked", shape=shape,
        kernel="flash_bwd_sm90 d=128", dq=rows[0], dk=rows[1], dv=rows[2],
        ms=f"{ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}",
        bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        plain_ms=f"{plain_ms:.1f}", library=f"sdpa backward[{backend}]",
        library_ms=f"{library_ms:.3f}", old_design="flash_bwd.cu",
        old_design_ms=f"{old_ms:.3f}",
        old_tflops=f"{flops / old_ms / 1e9:.1f}",
        old_design_errs=",".join(old_rows),
        **{key: f"{k8[key]:.4f}" for key in ("device_ms",
                                             "old_design_device_ms",
                                             "library_device_ms")
           if key in k8}, ok=ok and old_ok)
    if not ok:
        raise AssertionError(f"K8 at {what}'s training shape disagrees "
                             "with the plain backward, or did not launch "
                             "flash_bwd_sm90 at d=128")
    if not old_ok:
        raise AssertionError("flash_bwd.cu disagrees with the plain backward "
                             f"at {what}'s training shape")
    del q, k, v, g, out, lse
    return k5, k8


# ---------------------------------------------------------------- phase 12
def check_f32_forward(A) -> None:
    """flash_fwd with f32 q, k, v against the f32 plain version at the 2D
    VAE's mid-attention shape of the narrow Open-Sora check (ch 32: one head
    of d=128 over 32×32 tokens, 4 frames) and one ragged causal shape."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    for label, (b, sq, sk, h, d, causal) in {
            "vae2d mid-attention, ch 32": (4, 1024, 1024, 1, 128, False),
            "d72 causal ragged": (2, 333, 333, 2, 72, True)}.items():
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda")
                for _ in range(2))
        before = A.flash_fwd.launches["K2"]
        out, lse = A.flash_fwd(q, k, v, sm_scale=d ** -0.5, causal=causal,
                               emit_lse=True)
        ref, ref_lse = A.flash_fwd_plain(q, k, v, sm_scale=d ** -0.5,
                                         causal=causal, emit_lse=True)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = F32_TOL * ref.abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = (out.dtype == torch.float32 and err <= tol
              and lse_err <= F32_TOL
              and A.flash_fwd.launches["K2"] == before + 1)
        ms = cuda_time_ms(lambda: A.flash_fwd(q, k, v, sm_scale=d ** -0.5,
                                              causal=causal), reps=20)
        log("f32", case=label, shape=f"B{b}xSq{sq}xSk{sk}xH{h}xd{d}",
            max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
            lse_err=f"{lse_err:.3e}", lse_tol=F32_TOL, ms=f"{ms:.4f}", ok=ok)
        if not ok:
            raise AssertionError(f"f32 flash_fwd disagrees with its plain "
                                 f"version ({label})")


# ---------------------------------------------------------------- phases 13-14
def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _dummy_data(frames: int, height: int, width: int) -> str:
    return (f"data.dataset={{target: videotuna_tpu.data.DatasetFromCSV, "
            f"params: {{csv_path: {TOY_CSV}, dummy: true, "
            f"num_frames: {frames}, resolution: [{height}, {width}]}}}}")


def _train_run(A, tag: str, argv, per_step: dict, lora: bool,
               resume: bool = True, on_built=None, on_fit=None,
               saves: bool = True, loader_of=None) -> dict:
    """``TRAIN_STEPS`` steps through the training CLI's trainer: loss,
    grad-norm and seconds per step, peak memory, launches per step (checked
    against ``per_step``), the trainable count, the checkpoint, that a LoRA
    run's b matrices (or a full fine-tune's EMA) moved; then, with
    ``resume``, a ``--resume`` run of ``run_train`` that must restore the
    last step.  ``on_built`` and ``on_fit`` are called with the trainer
    once it is built and once its steps are checked; without ``saves``
    the run's checkpoint is not required (its trainer writes none).
    ``loader_of``, given the trainer, returns the batches to train on in
    place of the config's loader."""
    import shutil
    from videotuna_tpu_torch.cli.train import build_trainer, run_train
    workdir = argv[argv.index("--workdir") + 1]
    shutil.rmtree(workdir, ignore_errors=True)
    trainer, loader, _ = build_trainer(argv)
    if loader_of is not None:
        loader = loader_of(trainer)
    log(tag, weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    if on_built is not None:
        on_built(trainer)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    n_trainable = trainer.num_trainable(state)
    ema0 = ({k: v.cpu() for k, v in state.ema_params.items()}
            if state.ema_params is not None else None)   # off the card
    # a LoRA run's b matrices start at 0 and move only if its steps train;
    # a full fine-tune's first leaves (host copies, off the card)
    moving = ([k for k in state.params if k.endswith("/b")] if lora
              else list(state.params)[:8])
    p0 = {k: state.params[k].detach().to("cpu", copy=True) for k in moving}
    zero_counts(A)
    state = trainer.fit(loader, state)
    torch.cuda.synchronize()
    launches = read_counts(A)
    sm90 = read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    free, total = torch.cuda.mem_get_info()
    # the card's memory left at the peak: its total less the CUDA context
    # and everything the caching allocator held at its most
    context = total - free - torch.cuda.memory_reserved()
    free_at_peak = total - context - torch.cuda.max_memory_reserved()
    hist = trainer.metrics_history
    for m in hist:
        log(tag, step=m["step"], loss=f"{m['loss']:.6f}",
            grad_norm=f"{m['grad_norm']:.6f}",
            sec=f"{1.0 / m['steps_per_sec']:.3f}")
    sec = [1.0 / m["steps_per_sec"] for m in hist[1:]]
    moved = max((state.params[k].detach().cpu() - v).abs().max().item()
                for k, v in p0.items())
    ema_moved = (max((v.cpu() - ema0[k]).abs().max().item()
                     for k, v in state.ema_params.items())
                 if ema0 is not None else None)
    got = {k: launches[k] / TRAIN_STEPS for k in per_step}
    ckpt = os.path.join(workdir, f"step_{TRAIN_STEPS}")
    files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    log(tag, steps=len(hist), sec_per_step_2_3=",".join(f"{x:.3f}"
                                                         for x in sec),
        peak_mem_gb=f"{peak / 1e9:.2f}",
        peak_reserved_gb=f"{torch.cuda.max_memory_reserved() / 1e9:.2f}",
        free_at_peak_gb=f"{free_at_peak / 1e9:.2f}",
        card_gb=f"{total / 1e9:.2f}", trainable=n_trainable,
        launches_per_step=got, sm90_launches=sm90,
        params_moved=f"{moved:.3e}",
        ema_moved=("none" if ema_moved is None else f"{ema_moved:.3e}"),
        checkpoint=",".join(files))
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in hist)
    if len(hist) != TRAIN_STEPS or not finite:
        raise AssertionError(f"{tag}: {len(hist)} steps, finite={finite}")
    if got != per_step:
        raise AssertionError(f"{tag}: launches per step {got}, expected "
                             f"{per_step}")
    if saves and ("state.pt" not in files
                  or (lora and "lora.pt" not in files)):
        raise AssertionError(f"{tag}: checkpoint files {files}")
    if lora and not moved > 0:
        raise AssertionError(f"{tag}: the LoRA b matrices did not move")
    if ema_moved is not None and not ema_moved > 0:
        raise AssertionError(f"{tag}: the EMA did not move")
    del ema0, p0
    if on_fit is not None:
        on_fit(trainer)
    _step_breakdown(trainer, loader, state, tag)
    del trainer, loader, state
    _free()
    out = dict(launches=launches, sm90=sm90, sec_per_step=sec,
               peak_gb=peak / 1e9, free_at_peak_gb=free_at_peak / 1e9)
    if not resume:
        return out
    zero_counts(A)
    resumed = run_train(argv + ["--resume"])
    step = resumed.step
    del resumed
    _free()
    log(tag, resume=f"restored step {step}", launches=read_counts(A))
    if step != TRAIN_STEPS or any(read_counts(A).values()):
        raise AssertionError(f"{tag}: --resume gave step {step}")
    return out


def _step_breakdown(trainer, loader, state, tag: str) -> None:
    """One more step taken apart, host clock around synchronised parts:
    the host data pipeline, the caption encode with the batch's copy to the
    card, the VAE encode, the denoiser's forward and backward, and the
    whole step (the optimizer's update is the difference).  After the
    checkpoint; its launches are not counted."""
    from videotuna_tpu_torch.data.prefetch import to_device
    peaks = {}

    def timed(fn, part=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if part is not None:
            peaks[part] = torch.cuda.max_memory_allocated() / 1e9
        return out, time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(9)
    batch, t_data = timed(lambda: next(iter(loader)))
    batch, t_text = timed(lambda: to_device(trainer.prepare_batch(batch),
                                            "cuda"))
    t_vae = 0.0    # a batch that carries its latents has no encode
    if "video" in batch:
        z, t_vae = timed(lambda: trainer.flow.encode_video(
            batch.pop("video"), gen), "vae_encode")
        batch["latents"] = z

    def fwd_bwd():
        if trainer.lora is None:
            trainer._bind(state.params)
        with trainer.loss_scope():
            loss, _ = trainer.flow.training_loss(batch, gen)
            loss.backward()
        if trainer.lora is None:
            trainer._module_grads(state.params)
        else:
            for p in state.params.values():
                p.grad = None

    _, t_fb = timed(fwd_bwd, "denoiser_fwd_bwd")
    _, t_step = timed(lambda: trainer.compiled_step()(state, batch, gen))
    log(tag, breakdown_sec=f"data={t_data:.3f},text_encode={t_text:.3f},"
        f"vae_encode={t_vae:.3f},denoiser_fwd_bwd={t_fb:.3f},"
        f"optimizer={t_step - t_fb:.3f}",
        step_without_data_and_encoders=f"{t_step:.3f}",
        peak_gb=",".join(f"{k}={v:.2f}" for k, v in peaks.items()))


def run_train_cog(A) -> dict:
    """CogVideoX-2B LoRA (rank 128 on every projection) at full width and
    depth, remat on, 3 steps on dummy video at 49×480×720 (13 latent
    frames + 226 text = 17,776 tokens), or 13 frames when the f32 VAE encode
    of 49 does not fit beside T5-XXL and the 2B weights."""
    from videotuna_tpu_torch.cli.train import build_trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    frames, cut = 49, "none"
    argv = None
    for frames in (49, 13):
        lat = (frames - 1) // 4 + 1
        argv = ["--config", CONFIG_2B_LORA, "--device", "cuda", "--quiet",
                "--workdir", os.path.join(OUT_DIR, f"train_cog_{frames}"),
                _dummy_data(frames, 480, 720),
                "flow.params.denoiser_config.params.remat=true",
                f"flow.params.denoiser_config.params.video_tokens="
                f"{lat * 30 * 45}",
                f"train.max_steps={TRAIN_STEPS}",
                f"train.ckpt_every={TRAIN_STEPS}", "train.log_every=1"]
        trainer = build_trainer(argv)[0]
        try:
            with torch.no_grad():
                trainer.flow.encode_video(
                    torch.zeros((1, frames, 480, 720, 3), device="cuda"),
                    torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            log("train-cog", encode_frames=frames,
                encode_peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                cut=cut)
            break
        except torch.cuda.OutOfMemoryError:
            cut = (f"13 frames: the f32 VAE encode of 49 frames ran out of "
                   f"memory at {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                   " GB beside T5-XXL and the 2B weights")
            log("train-cog", cut=cut.replace(" ", "_"))
        finally:
            del trainer
            _free()
    tokens = ((frames - 1) // 4 + 1) * 1350 + 226
    log("train-cog", config="cogvideo2b_lora", frames=frames, height=480,
        width=720, tokens=tokens, lora_rank=128, remat=True, cut=cut)
    # forward K1 per layer, K1 again when remat recomputes it, K7 backward
    per_step = {"K1": 60, "K7": 30, "K2": 0, "K5": 0, "K8": 0, "K10": 0}
    out = _train_run(A, "train-cog", argv, per_step, lora=True)
    if (out["sm90"]["K7"], out["sm90"]["K1"]) != (30 * TRAIN_STEPS,
                                                  60 * TRAIN_STEPS) \
            or out["sm90"]["tma_copies"]:
        raise AssertionError(f"train-cog: {out['sm90']}: every K7 launch "
                             f"must run flash_bwd_sm90 ({30 * TRAIN_STEPS}) "
                             f"and every K1 launch flash_fwd_sm90 "
                             f"({60 * TRAIN_STEPS}), with no alignment copy")
    check_split_counts("train-cog", out["sm90"])
    return dict(out, frames=frames, cut=cut)


def run_train_stdit(A) -> dict:
    """Open-Sora v1.0 STDiT-XL/2 full fine-tune at full width and depth
    (lr 2e-5, warmup 1000, EMA 0.9999, clip 1): 3 steps on dummy video at
    16×256×256."""
    argv = ["--config", CONFIG_OS, "--device", "cuda", "--quiet",
            "--workdir", os.path.join(OUT_DIR, "train_stdit"),
            _dummy_data(16, 256, 256), f"train.max_steps={TRAIN_STEPS}",
            f"train.ckpt_every={TRAIN_STEPS}", "train.log_every=1"]
    torch.cuda.empty_cache()
    log("train-stdit", config="opensorav10_256x256", frames=16, height=256,
        width=256, remat=False)
    # spatial self-attention K5 forward + K8 backward; caption
    # cross-attention K4 forward + K8 backward with the key mask
    per_step = {"K5": OS_DEPTH, "K4": OS_DEPTH, "K8": 2 * OS_DEPTH,
                "K7": 0, "K1": 0}
    out = _train_run(A, "train-stdit", argv, per_step, lora=False)
    if out["sm90"]["K5"] != OS_DEPTH * TRAIN_STEPS \
            or out["sm90"]["K4"] != OS_DEPTH * TRAIN_STEPS \
            or out["sm90"]["K8"] != 2 * OS_DEPTH * TRAIN_STEPS \
            or out["sm90"]["tma_copies"]:
        raise AssertionError(f"train-stdit: {out['sm90']}: every K5 and K4 "
                             f"launch must run flash_fwd_sm90 ({OS_DEPTH} "
                             "a step each, none on flash_fwd.cu), with no "
                             "alignment copy, and every K8 launch "
                             f"flash_bwd_rows_sm90 ({2 * OS_DEPTH} a step, "
                             "none on flash_bwd.cu)")
    check_split_counts("train-stdit", out["sm90"])
    return out


def _hunyuan_lora_argv(frames: int):
    """The registry's ``train-hunyuan-t2v-lora`` command line (its configs
    and overrides) with this run's: one card (the config's mesh is for 8
    and 2), remat, dummy video, ``TRAIN_STEPS`` steps, a log line each."""
    from videotuna_tpu_torch.cli.commands import COMMANDS
    cmd = COMMANDS[HY_LORA_COMMAND]
    argv = []
    for cfg in cmd.configs:
        argv += ["--config", cfg]
    return argv + [
        "--device", "cuda", "--quiet", "--max_steps", str(TRAIN_STEPS),
        "--workdir", os.path.join(OUT_DIR, f"train_hunyuan_{frames}")] \
        + cmd.overrides + [
        "train.mesh.fsdp=1", "train.mesh.sp=1",
        "flow.params.denoiser_config.params.remat=true",
        _dummy_data(frames, *HY_TRAIN_SIZE),
        f"train.ckpt_every={TRAIN_STEPS}", "train.log_every=1"]


def run_train_hunyuan(A, frames: int = HY_TRAIN_FRAMES,
                      resume: bool = True) -> dict:
    """HunyuanVideo T2V LoRA (rank 64 on every matched projection of the 13B
    DiT: dim 3072, 20 double and 40 single blocks, 24 heads of d=128; LLaMA
    and CLIP in f32; remat) through the registry's command, 3 steps on dummy
    video at ``frames``×720×1280, then ``--resume``.  Per step: K5 = 120
    (each block's joint attention forward, and again when remat recomputes
    it), K8 = 60 (its backward), every one on the Hopper designs at d = 128
    (K3's kernel with the LSE, flash_bwd_sm90), and K2 = 32 (the f32 causal
    LLaMA layers of the caption encode) on flash_fwd.cu."""
    height, width = HY_TRAIN_SIZE
    _free()
    lat = (frames - 1) // 4 + 1
    tokens = lat * (height // 16) * (width // 16) + 256
    log("train-hunyuan", command=HY_LORA_COMMAND, frames=frames,
        height=height, width=width, latent_frames=lat,
        tokens_per_attention=tokens, lora_rank=64, remat=True,
        cut=f"frames {frames} of the config's 129 ({height}x{width} held)",
        resident_before_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    per_step = {"K5": 2 * HY_DEPTH, "K8": HY_DEPTH, "K2": HY_LLAMA_LAYERS,
                "K1": 0, "K3": 0, "K4": 0, "K6": 0, "K7": 0, "K9": 0,
                "K10": 0}
    out = _train_run(A, "train-hunyuan",
                     _hunyuan_lora_argv(frames), per_step,
                     lora=True, resume=resume)
    sm90 = out["sm90"]
    hopper = {k: (sm90[k], sm90[f"{k}_d128"]) for k in ("K5", "K8")}
    if hopper != {k: (n * TRAIN_STEPS,) * 2 for k, n in (
            ("K5", per_step["K5"]), ("K8", per_step["K8"]))} \
            or sm90["K2"]:
        raise AssertionError(f"train-hunyuan: {sm90}: every K5 and K8 must "
                             "run the Hopper designs at d=128 (K3's kernel "
                             "with the LSE, flash_bwd_sm90)")
    # every LLaMA K2 (32 a step) on the f32 design, split, none on
    # flash_fwd.cu
    check_split_counts("train-hunyuan", sm90,
                       llama=per_step["K2"] * TRAIN_STEPS)
    return dict(out, frames=frames, tokens=tokens)


# ---------------------------------------------------------------- phase 15
def _grads_close(tag, named_gpu, named_cpu):
    """Each trainable gradient, card against CPU, within TRAIN_GRAD_TOL of
    its own max|g| plus TRAIN_GRAD_TOL/100 of the largest (gradients that
    are 0 in exact arithmetic, such as a key projection's bias, are bf16
    rounding noise on both sides).  Returns the largest err/tol and its
    gradient's name, and the largest err/max|g| over the gradients whose
    max is at least 1% of the largest."""
    gmax = max(g.abs().max().item() for g in named_cpu.values())
    worst, worst_name, worst_rel = 0.0, "", 0.0
    for name, gc_ in named_cpu.items():
        gg = named_gpu[name].float().cpu()
        err = (gg - gc_).abs().max().item()
        own = gc_.abs().max().item()
        tol = TRAIN_GRAD_TOL * (own + gmax / 100)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{tag}: gradient of {name} differs by "
                                 f"{err:.3e} > {tol:.3e}")
        if err / tol > worst:
            worst, worst_name = err / tol, name
        if own >= gmax / 100:
            worst_rel = max(worst_rel, err / own)
    return worst, worst_name, worst_rel


@tf32_off()
def check_train_reference(A, only=None) -> None:
    """One training step of each flow at narrow width, on the card and on
    the CPU, with the same weights, batch, t, noise and LoRA tree, TF32 off:
    CogVideoX (2 layers, 2 heads of d=64, LoRA rank 8, 128 video + 226 text
    tokens: K1 and K7), STDiT (2 layers, 2 heads of d=72, 4×32×32 latents,
    256 spatial tokens and a 13-of-120 caption: K5, K4, K8) and
    HunyuanVideo (dim 256, 2 heads of d=128, 1 double and 2 single blocks,
    LoRA rank 8, 192 image + 160 text tokens, σ = 0.417, pooled text: K5 and
    K8 under the fixed max, on the Hopper designs at d=128); with ``only``
    ("flux_d128"), Flux-dev (``_narrow_flux``: 2 heads of d=128, 1 double
    and 2 single blocks, LoRA rank 8, 8×16 packed latents: 128 image + 32
    text tokens, σ = 0.417, pooled text, final_proj drawn: K5 online and
    K8 on the Hopper designs at d=128), or ("opensora12") Open-Sora 1.2's
    STDiT3 under the rectified flow (2 layers, 2 heads of d=72, as STDiT's
    case, σ = 0.417: K5, K4, K8).  Every card launch must be on a
    Hopper design.  Loss within TRAIN_LOSS_TOL relative, gradients within
    TRAIN_GRAD_TOL (bf16 models on both sides, summed in other orders)."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.training.lora import (flatten_tree, init_lora,
                                                   lora_scope,
                                                   unflatten_tree)
    den = "flow.params.denoiser_config.params"
    t5 = "flow.params.cond_stage_config.params"
    narrow_t5 = [f"{t5}.dim=64", f"{t5}.heads=2", f"{t5}.head_dim=32",
                 f"{t5}.ff_dim=128", f"{t5}.num_layers=1",
                 "flow.params.first_stage_config.params.ch=32",
                 "flow.params.first_stage_config.params.num_res_blocks=1"]
    cases = {
        "cogvideox": (CONFIG_2B_LORA,
                      [f"{den}.dim=128", f"{den}.heads=2",
                       f"{den}.num_layers=2", f"{den}.text_dim=64",
                       f"{den}.video_tokens=128"] + narrow_t5,
                      (1, 2, 16, 16, 16), (1, 226, 64), None,
                      {"K1": 2, "K7": 2}),
        "stdit": (CONFIG_OS,
                  [f"{den}.hidden_size=144", f"{den}.num_heads=2",
                   f"{den}.depth=2", f"{den}.caption_channels=64"]
                  + narrow_t5,
                  (1, 4, 32, 32, 4), (1, 120, 64), 13,
                  {"K5": 2, "K4": 2, "K8": 4}),
        # dim 256, 2 heads of d=128, 1 double + 2 single blocks; 3×16×16
        # latents: 192 image + 160 text tokens in each joint attention
        "hunyuan_d128": (os.path.join(ROOT, "configs", "007_hunyuanvideo",
                                      "hunyuanvideo_t2v_lora.yaml"),
                         _narrow_hunyuan(),
                         (1, 3, 16, 16, 16), (1, 160, 256), 13,
                         {"K5": 3, "K8": 3}),
        "flux_d128": (CONFIG_FLUX_LORA, _narrow_flux(), (1, 8, 16, 64),
                      (1, 32, 64), None, {"K5": 3, "K8": 3}),
        # Open-Sora 1.2's rectified flow (STDiT3: qk-norm, temporal RoPE),
        # its remat off: the recompute would run each forward twice
        "opensora12": (CONFIG_OS12,
                       [f"{den}.hidden_size=144", f"{den}.num_heads=2",
                        f"{den}.depth=2", f"{den}.caption_channels=64",
                        f"{den}.remat=false"] + narrow_t5,
                       (1, 4, 32, 32, 4), (1, 120, 64), 13,
                       {"K5": 2, "K4": 2, "K8": 4}),
    }
    only = only or [c for c in cases if c not in ("flux_d128",
                                                  "opensora12")]
    for name, (config, overrides, zshape, yshape, n_valid, expect) \
            in ((c, cases[c]) for c in only):
        cfg = load_configs([config], overrides)
        cpu = instantiate(cfg["flow"], device="cpu")
        gpu = instantiate(cfg["flow"], device="cuda")
        cpu.init_params(seed=1)
        if name == "flux_d128":
            _draw_final_proj(cpu, 5)
        for comp, module in cpu.components().items():
            gpu.components()[comp].load_state_dict(module.state_dict())
        gen = torch.Generator().manual_seed(2)
        z = torch.randn(zshape, generator=gen)
        noise = torch.randn(zshape, generator=gen)
        y = torch.randn(yshape, generator=gen)
        batch = {"latents": z, "text_states": y}
        if name.endswith("_d128"):   # CLIP's vector
            batch["pooled_text"] = torch.randn((1, 64), generator=gen)
        if name.endswith("_d128") or name == "opensora12":   # σ, not t
            draw = {"sigma": torch.tensor([0.417])}
        else:
            draw = {"t": torch.tensor([417])}
        if n_valid is not None:
            mask = torch.zeros(yshape[:2], dtype=torch.bool)
            mask[:, :n_valid] = True
            batch["text_mask"] = mask
        tree = None
        if name not in ("stdit", "opensora12"):
            # LoRA: a from the init, b small random
            tree = init_lora(cpu.denoiser, rank=8,
                             generator=torch.Generator().manual_seed(3))
            for path, leaf in flatten_tree(tree).items():
                if path.endswith("/b"):
                    with torch.no_grad():
                        leaf.normal_(0.0, 0.01, generator=gen)
        losses, grads = [], []
        for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
            flow_tree = None
            if tree is not None:
                flow_tree = unflatten_tree(
                    {k: v.detach().to(dev).requires_grad_()
                     for k, v in flatten_tree(tree).items()})
                params = flatten_tree(flow_tree)
            else:
                flow.denoiser.requires_grad_(True)
                params = dict(flow.denoiser.named_parameters())
            zero_counts(A)
            with contextlib.ExitStack() as stack:
                if flow_tree is not None:
                    stack.enter_context(lora_scope(flow.denoiser, flow_tree))
                stack.enter_context(flow._attn_scope())
                loss, _ = flow.training_loss(
                    {k: v.to(dev) for k, v in batch.items()},
                    noise=noise.to(dev),
                    **{k: v.to(dev) for k, v in draw.items()})
                loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in read_counts(A).items() if v}
                hopper = {k: v for k, v in read_sm90_counts(A).items()
                          if v and k.startswith("K")}
            losses.append(loss.item())
            grads.append({k: p.grad.float().cpu() for k, p in params.items()
                          if p.grad is not None})
        rel = abs(losses[1] - losses[0]) / abs(losses[0])
        worst, worst_name, worst_rel = _grads_close(
            f"train-reference {name}", grads[1], grads[0])
        # every launch on a Hopper design; HunyuanVideo's at d=128, STDiT's
        # K8 (d=72) on flash_bwd_rows_sm90
        expect_hopper = dict(expect, **({f"{k}_d128": n
                                         for k, n in expect.items()}
                                        if name.endswith("_d128")
                                        else {}),
                             **({"K8_rows": expect["K8"]}
                                if name in ("stdit", "opensora12")
                                else {}))
        ok = (math.isfinite(rel) and rel <= TRAIN_LOSS_TOL
              and launches == expect and hopper == expect_hopper
              and set(grads[0]) == set(grads[1]))
        log("train-reference", flow=name, loss_cpu=f"{losses[0]:.6f}",
            loss_card=f"{losses[1]:.6f}", loss_rel_err=f"{rel:.3e}",
            loss_tol=TRAIN_LOSS_TOL, grads=len(grads[0]),
            worst_grad_err_over_tol=f"{worst:.3f}", worst_grad=worst_name,
            grad_rel_err=f"{worst_rel:.3e}", grad_tol=TRAIN_GRAD_TOL,
            card_launches=launches, hopper_launches=hopper, tf32=tf32_flags(),
            ok=ok)
        if not ok:
            raise AssertionError(f"train-reference {name}: card and CPU "
                                 "disagree")
        del cpu, gpu
        _free()


# ---------------------------------------------------------------- phases 16-18
def _rms(x: torch.Tensor) -> torch.Tensor:
    """RMSNorm per head in f32, as the HunyuanVideo DiT's q_norm / k_norm
    (unit scale): bounded logits, |s·log2e| ≤ √128·log2e ≈ 16.3."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)


def _plain_k3_chunked(A, q, k, v, rows):
    """flash_fwd_plain under the fixed max over all query rows, a block of
    rows at a time (the full score tensor would take 1.4 TB)."""
    return torch.cat([A.flash_fwd_plain(q[:, i:i + rows], k, v,
                                        sm_scale=q.shape[-1] ** -0.5,
                                        static_max=0.0)
                      for i in range(0, q.shape[1], rows)], dim=1)


def check_k3(A) -> dict:
    """K3, the fixed-max route at d ≤ 128, through ``flash_attention``
    (which launches flash_fwd counted as K3): against the plain version at
    the HunyuanVideo 13B joint-attention shape (B=1, S=119,056 with a
    16-key tail, H=24, d=128), the plain version 128 query rows at a time,
    and at B=2, S=4096; timed at the full shape beside its bound, the plain
    version and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s, h = SHAPE_HY["b"], SHAPE_HY["s"], SHAPE_HY["h"]
    d = 128
    # the full shape last: its tensors and plain time serve the timing
    for label, (bb, ss, rows) in {"B2 S4096": (2, 4096, 1024),
                                  "hunyuan 13B joint": (b, s, 128)}.items():
        q, k = (_rms(torch.randn((bb, ss, h, d), generator=gen,
                                 device="cuda")).bfloat16()
                for _ in range(2))
        v = torch.randn((bb, ss, h, d), generator=gen,
                        device="cuda").bfloat16()
        before = (A.flash_fwd.launches["K3"],
                  A.flash_fwd.launches_sm90["K3"], A.flash_fwd.tma_copies)
        out = A.flash_attention(q, k, v, static_max=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = _plain_k3_chunked(A, q, k, v, rows)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = (err <= FWD_TOL * scale
              and (A.flash_fwd.launches["K3"], A.flash_fwd.launches_sm90["K3"],
                   A.flash_fwd.tma_copies)
              == (before[0] + 1, before[1] + 1, before[2]))
        log("K3", case=label, shape=f"B{bb}xS{ss}xH{h}xd{d}",
            kernel="flash_fwd_sm90", static_max=0.0, key_tail=ss % 128,
            max_abs_err=f"{err:.3e}", tol=f"{FWD_TOL * scale:.3e}",
            plain_ms=f"{plain_ms:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version "
                                 f"({label}), or did not launch "
                                 f"flash_fwd_sm90 in place")
        # the old design (flash_fwd.cu) on the same tensors
        old = A._flash_fwd_mma(q, k, v, d ** -0.5, False, None, 0.0, False)
        torch.cuda.synchronize()
        old_err = (old.float() - ref.float()).abs().max().item()
        log("K3", case=label, compare="flash_fwd.cu (the mma.sync design) "
            "on the same tensors", max_abs_err=f"{old_err:.3e}",
            tol=f"{FWD_TOL * scale:.3e}", ok=old_err <= FWD_TOL * scale)
        if old_err > FWD_TOL * scale:
            raise AssertionError(f"flash_fwd disagrees at K3's shape "
                                 f"({label})")
        del out, ref, old
    flops = 4.0 * b * h * s * s * d
    bound_ms, bound_by = _bound(flops, 4 * q.numel() * q.element_size())
    ms = cuda_time_ms(lambda: A.flash_attention(q, k, v, static_max=0.0),
                      reps=3)
    old_ms = cuda_time_ms(lambda: A._flash_fwd_mma(
        q, k, v, d ** -0.5, False, None, 0.0, False), reps=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=3)
    log("K3", case="hunyuan 13B joint timing", kernel="flash_fwd_sm90",
        ms=f"{ms:.3f}", bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        tflops=f"{flops / ms / 1e9:.1f}", plain_ms=f"{plain_ms:.1f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{library_ms:.3f}")
    log("K3", compare="flash_fwd (the mma.sync design) at the full shape",
        ms=f"{old_ms:.3f}", tflops=f"{flops / old_ms / 1e9:.1f}",
        sm90_ms=f"{ms:.3f}", faster=ms < old_ms)
    if not ms < old_ms:
        raise AssertionError("flash_fwd_sm90 is not faster than flash_fwd "
                             "at K3's full shape")
    del q, k, v, qt, kt, vt
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                old_design_ms=old_ms)


def run_e2e_hunyuan(A) -> dict:
    """``run_inference`` on configs/007_hunyuanvideo/hunyuanvideo_t2v.yaml
    at full width and depth (dim 3072, 20 double and 40 single blocks, 24
    heads of d=128, bf16; LLaMA 4096×32 and CLIP-L in f32; HunyuanVAE),
    random weights from the seed, one prompt at 129×720×1280 (118,800 video
    tokens + 256 text).  Cut: 1 of the 50 steps, and the VAE decodes the
    first 2 latent frames (5 pixel frames)."""
    from videotuna_tpu_torch.cli.inference import run_inference
    savedir = os.path.join(OUT_DIR, "e2e_hunyuan")
    _free()
    resident = torch.cuda.memory_allocated()   # left by earlier phases
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    t0 = time.perf_counter()
    result = run_inference([
        "--config", CONFIG_HY, "--device", "cuda", "--quiet",
        "--savedir", savedir,
        "--prompt", "a panda playing guitar by a lake at sunset",
        f"flow.params.scheduler_config.params.num_steps={HY_STEPS}",
        f"inference.decode_latent_frames={HY_DECODE_LATENT_FRAMES}",
    ])
    wall = time.perf_counter() - t0
    launches = read_counts(A)
    sm90 = read_sm90_counts(A)
    m = result["metrics"]
    peak = torch.cuda.max_memory_allocated()
    frames = 1 + 4 * (HY_DECODE_LATENT_FRAMES - 1)
    video = _read_video(result["videos"][0])
    log("e2e-hunyuan", config="hunyuanvideo_t2v", frames_sampled=129,
        height=720, width=1280, tokens=SHAPE_HY["s"],
        steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", decoded_frames=frames,
        run_sec=f"{wall:.1f}", resident_before_gb=f"{resident / 1e9:.2f}",
        peak_mem_gb=f"{peak / 1e9:.2f}",
        launches=launches, sm90_launches=sm90,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    expected = dict({k: 0 for k in launches}, K3=HY_DEPTH * HY_STEPS,
                    K2=HY_LLAMA_LAYERS)
    if m["denoise_steps"] != HY_STEPS or launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}: "
                             f"K3 = {HY_DEPTH} blocks × {HY_STEPS} steps, "
                             f"K2 = {HY_LLAMA_LAYERS} LLaMA layers, no other")
    if sm90["K3"] != HY_DEPTH * HY_STEPS or sm90["tma_copies"]:
        raise AssertionError(f"{sm90}: every K3 launch must run "
                             f"flash_fwd_sm90 ({HY_DEPTH * HY_STEPS}), with "
                             f"no alignment copy")
    # every LLaMA K2 on the f32 design, split, none on flash_fwd.cu
    check_split_counts("e2e-hunyuan", sm90, llama=HY_LLAMA_LAYERS)
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError("non-finite latents or pixels")
    if tuple(video.shape) != (frames, 720, 1280, 3):
        raise AssertionError(f"video shape {video.shape}")
    if not os.path.isfile(os.path.join(savedir, "metric.json")):
        raise AssertionError("metric.json missing")
    del result
    _free()
    return dict(launches=launches, sm90=sm90)


def profile_hunyuan_call() -> dict:
    """One full-width HunyuanVideo DiT call at 129×720×1280 (B=1: 118,800
    video tokens and a 256-token prompt with 13 valid, pooled text and
    embedded guidance) under the flow's fixed max, the work of one sampling
    step: timed with CUDA events around the traced call, device time by
    kernel group and the busy share from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    import videotuna_tpu_torch.kernels.attention as A
    _free()
    cfg = load_configs([CONFIG_HY])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((1, 33, 90, 160, 16), generator=gen, device="cuda")
    y = torch.randn((1, 256, 4096), generator=gen, device="cuda")
    pooled = torch.randn((1, 768), generator=gen, device="cuda")
    mask = torch.zeros((1, 256), dtype=torch.bool, device="cuda")
    mask[0, :13] = True
    t = torch.tensor([500.0], device="cuda")
    g = torch.tensor([6000.0], device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode(), A.attention_options(static_max=0.0), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        start.record()
        model(x, t, y, pooled, mask, g)
        end.record()
        torch.cuda.synchronize()
    del model
    _free()
    return _log_profile("profile-hunyuan",
                        "one HunyuanVideo 13B DiT call, 119,056 tokens",
                        prof, start.elapsed_time(end), "flash_fwd_sm90 (K3)")


def _narrow_hunyuan():
    """HunyuanVideo at narrow width, d=128 kept: the DiT at dim 256 (2
    heads, 1 double and 2 single blocks), a 2-layer LLaMA of dim 256, a
    2-layer CLIP of dim 64, the VAE at (32, 32, 64, 64), 160 text tokens."""
    den = "flow.params.denoiser_config.params"
    llama = "flow.params.cond_stage_config.params"
    clip = "flow.params.cond_stage_2_config.params"
    vae = "flow.params.first_stage_config.params"
    return [
        f"{den}.dim=256", f"{den}.heads=2", f"{den}.double_blocks=1",
        f"{den}.single_blocks=2", f"{den}.text_dim=256",
        f"{llama}.dim=256", f"{llama}.heads=2", f"{llama}.num_layers=2",
        f"{clip}.dim=64", f"{clip}.heads=2",
        f"{clip}.num_layers=2", f"{den}.pooled_dim=64",
        f"{vae}.block_out_channels=[32, 32, 64, 64]",
        f"{vae}.norm_num_groups=8", "flow.params.model_max_length=160"]


@tf32_off()
def check_small_reference_hunyuan() -> None:
    """The narrow HunyuanVideo flow (dim 256, 2 heads of d=128, 1 double
    and 2 single blocks, a 2-layer LLaMA of d=128 over 160 tokens, the VAE
    at (32, 32, 64, 64)) on the card and on the CPU with the same weights,
    prompt and x_T, TF32 off: 3×16×16 latents give 192 + 160 joint tokens,
    so K3 and the f32 K2 are on the card's path.  One denoiser call, the
    latents after 2 steps and the decode of the same latents must agree."""
    from videotuna_tpu_torch.core.config import load_configs
    import videotuna_tpu_torch.kernels.attention as A
    cfg = load_configs([CONFIG_HY], _narrow_hunyuan() + [
        f"flow.params.scheduler_config.params.num_steps={HY_REF_STEPS}"])
    _flow_card_vs_cpu(
        A, "reference-hunyuan", cfg, (9, 128, 128),
        lambda flow: flow.scheduler.timesteps[1].reshape(1),
        "a panda playing guitar by a lake",
        {"K3": 3 * (1 + HY_REF_STEPS), "K2": 2}, {},
        (REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE))


def _flow_card_vs_cpu(A, phase, cfg, size, t_of, prompt, expected, designs,
                      tols, prepare=None, condition=None, card=None,
                      control=False):
    """A narrow flow built from ``cfg`` on the card and on the CPU with the
    same seeded weights (``prepare`` may change the CPU flow's first), the
    same prompt and x_T of the latents of ``size`` (frames, H, W): one
    denoiser call at ``t_of(flow)``, the latents after the flow's steps
    (no CFG) and the decode of the CPU's latents must agree within
    ``tols``; the card's launches must be ``expected``, and each of
    ``designs`` (a ``read_sm90_counts`` key) its count.  ``condition(flow,
    cond, device)`` replaces the text conditioning on both sides (the
    image of an I2V flow); ``card(flow)`` changes the card's flow after
    its weights are copied; a ``control`` must disagree."""
    from videotuna_tpu_torch.core.registry import instantiate
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    if prepare is not None:
        prepare(cpu)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    if card is not None:
        card(gpu)
    shape = cpu.latent_shape(1, *size)
    x_T = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    t = t_of(cpu)
    outs, z_cpu, launches, sm90 = [], None, {}, {}
    for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
        zero_counts(A)
        cond = flow.encode_text([prompt])
        if condition is not None:
            cond = condition(flow, cond, dev)
        with torch.inference_mode(), flow._attn_scope():
            call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
        z = flow.sample(cond, None, shape, None, 1.0, x_T=x_T.to(dev))
        launches = {k: v for k, v in read_counts(A).items() if v}
        sm90 = read_sm90_counts(A)
        z_cpu = z if z_cpu is None else z_cpu
        video = flow.decode_latents(z_cpu.to(dev))
        outs.append([x.float().cpu() for x in (call, z, video)])
    if launches != expected or any(sm90[k] != n for k, n in designs.items()):
        raise AssertionError(f"{phase}: the narrow flow on the card launched "
                             f"{launches}, {sm90}; expected {expected}, "
                             f"{designs}")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log(phase, what="narrow flow, cuda vs cpu"
        + (" (control: must disagree)" if control else ""),
        latent_shape=list(shape),
        steps=gpu.scheduler.num_steps, card_launches=launches,
        denoiser_call_rel_err=f"{errs[0]:.3e}", call_tol=tols[0],
        latent_rel_err=f"{errs[1]:.3e}", latent_tol=tols[1],
        decode_rel_err=f"{errs[2]:.3e}", decode_tol=tols[2],
        ok=ok != control)
    if ok == control:
        raise AssertionError(f"{phase}: the card's flow "
                             + ("agrees with the CPU's: the control cannot "
                                "fail" if control else
                                "disagrees with the CPU's"))
    del cpu, gpu
    _free()


# ---------------------------------------------------------------- phases 23-27
def _wan_qkv(b, sq, sk, h, gen):
    """Wan's q and k (RMSNormed over the full width h·128 before the head
    split: bounded logits) and v, bf16 on the card."""
    q, k, v = (torch.randn((b, s, h * 128), generator=gen, device="cuda")
               for s in (sq, sk, sk))
    q, k = (_rms(x) for x in (q, k))
    return [x.unflatten(-1, (h, 128)).bfloat16() for x in (q, k, v)]


def check_k3_wan(A) -> dict:
    """K3 at Wan 2.1's shapes, B=2 under CFG, d=128, the fixed max 0,
    through ``flash_attention`` (K3's Hopper kernel in place): the 14B
    self-attention (75,600 tokens, H=40), the 1.3B self-attention (32,760,
    H=12) and the 14B text cross-attention (75,600 queries over 512 keys,
    H=40), each against its plain version (a block of query rows at a
    time) and timed beside its bound, the plain version and SDPA."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    gen = torch.Generator(device="cuda").manual_seed(12)
    recs = {}
    for case, (b, sq, sk, h) in WAN_K3_CASES.items():
        q, k, v = _wan_qkv(b, sq, sk, h, gen)
        before = (A.flash_fwd.launches["K3"],
                  A.flash_fwd.launches_sm90["K3"],
                  A.flash_fwd.launches_d128["K3"], A.flash_fwd.tma_copies)
        out = A.flash_attention(q, k, v, static_max=0.0)
        torch.cuda.synchronize()
        launched = (A.flash_fwd.launches["K3"],
                    A.flash_fwd.launches_sm90["K3"],
                    A.flash_fwd.launches_d128["K3"], A.flash_fwd.tma_copies)
        t0 = time.perf_counter()
        ref = _plain_k3_chunked(A, q, k, v, 128 if sq == sk else 1024)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = (err <= FWD_TOL * scale and bool(torch.isfinite(out).all())
              and launched == (before[0] + 1, before[1] + 1, before[2] + 1,
                               before[3]))
        log("K3-wan", case=case, shape=f"B{b}xSq{sq}xSk{sk}xH{h}xd128",
            kernel="flash_fwd_sm90", static_max=0.0, key_tail=sk % 128,
            max_abs_err=f"{err:.3e}", tol=f"{FWD_TOL * scale:.3e}",
            plain_ms=f"{plain_ms:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"Wan's {case} shape, or did not launch "
                                 f"K3's kernel in place")
        del out, ref
        flops = 4.0 * b * h * sq * sk * 128
        io_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bound_ms, bound_by = _bound(flops, io_bytes)
        ms = cuda_time_ms(lambda: A.flash_attention(q, k, v, static_max=0.0),
                          reps=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=3)
        del qt, kt, vt
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        extra = {}
        if ms < 0.2:   # a short call: its device time, without the host's
            rec["device_ms"] = device_ms(
                lambda: A.flash_attention(q, k, v, static_max=0.0), 20)
            extra["device_ms"] = f"{rec['device_ms']:.4f}"
        log("K3-wan", case=f"{case} timing", kernel="flash_fwd_sm90",
            ms=f"{ms:.3f}", **extra, bound_ms=f"{bound_ms:.3f}",
            bound_by=bound_by, tflops=f"{flops / ms / 1e9:.1f}",
            of_bound=f"{bound_ms / ms:.3f}", plain_ms=f"{plain_ms:.1f}",
            library=f"scaled_dot_product_attention[{backend}]",
            library_ms=f"{library_ms:.3f}",
            vs_library=f"{library_ms / ms:.3f}")
        recs[case] = rec
        del q, k, v
        _free()
    return recs


def _wan_command_argv(name: str, savedir: str, extra=()):
    return [name, "--device", "cuda", "--quiet", "--savedir", savedir,
            "--prompt", WAN_PROMPT, *extra]


def _run_wan(A, phase: str, name: str, tag: str, steps: int, depth: int,
             frames: int, size, tokens: int, extra=(),
             attn_per_layer: int = 2, clip_k2: int = 0) -> dict:
    """One prompt through the registry's ``name`` at full width: the
    launch counts (K3 = ``attn_per_layer``·depth a step: each block's self-
    and text cross-attention, and for I2V its image cross-attention, at
    B = 2 under CFG, all on K3's Hopper kernel in place; I2V's CLIP image
    encoder's ``clip_k2`` f32 K2 on the split f32 design; no other
    launch), finite
    latents and pixels, the mp4's frames and metric.json; logs seconds per
    step, the text (and image) encode, the decode and the peak memory."""
    from videotuna_tpu_torch.cli.commands import main as command
    savedir = os.path.join(OUT_DIR, tag)
    _free()
    resident = torch.cuda.memory_allocated()    # left by earlier phases
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    t0 = time.perf_counter()
    rc = command(_wan_command_argv(name, savedir, extra))
    wall = time.perf_counter() - t0
    launches = read_counts(A)
    sm90 = read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(savedir, "metric.json")) as f:
        m = json.load(f)
    videos = sorted(p for p in os.listdir(savedir)
                    if p.endswith((".mp4", ".npy")))
    video = _read_video(os.path.join(savedir, videos[0]))
    height, width = size
    log(phase, command=name, frames=frames, height=height, width=width,
        tokens=tokens, text_tokens=WAN_TEXT, batch="2 (CFG)",
        steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        image_encode_sec=f"{m['image_encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", run_sec=f"{wall:.1f}",
        resident_before_gb=f"{resident / 1e9:.2f}",
        peak_mem_gb=f"{peak / 1e9:.2f}",
        k3_per_step=launches["K3"] / max(m["denoise_steps"], 1),
        launches=launches, sm90_launches=sm90,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    k3 = attn_per_layer * depth * steps
    expected = dict({k: 0 for k in launches}, K3=k3, K2=clip_k2)
    if rc != 0 or m["denoise_steps"] != steps or launches != expected:
        raise AssertionError(f"{phase}: rc {rc}, launches {launches}, "
                             f"expected {expected}: K3 = {depth} blocks × "
                             f"{attn_per_layer} attentions × {steps} steps, "
                             f"the CLIP encoder's {clip_k2} K2, no other")
    if (sm90["K3"], sm90["K3_d128"], sm90["K2"], sm90["tma_copies"]) \
            != (k3, k3, 0, 0):
        raise AssertionError(f"{phase}: {sm90}: every K3 launch must run K3's "
                             "Hopper kernel at d=128, with no alignment "
                             "copy, and the f32 K2 the f32 design")
    check_split_counts(phase, sm90, clip=clip_k2)
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError(f"{phase}: non-finite latents or pixels")
    if len(videos) != 1 or tuple(video.shape) != (frames, height, width, 3):
        raise AssertionError(f"{phase}: videos {videos}, shape "
                             f"{video.shape}")
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                sec_per_step=m["sample_sec"] / m["denoise_steps"],
                text_encode_sec=m["encode_sec"],
                image_encode_sec=m["image_encode_sec"],
                decode_sec=m["decode_sec"])


def run_e2e_wan14b(A) -> dict:
    """Wan 2.1 T2V 14B through the registry's ``inference-wanvideo-t2v-720p``
    (configs/008_wanvideo/wan2_1_t2v_14B.yaml) at full width and depth (dim
    5120, 40 layers, 40 heads of d=128, ffn 13,824, bf16; T5-XXL in f32 over
    512 tokens; the Wan VAE in f32), random weights from the seed, one
    prompt at 81×720×1280 (21×90×160 latents, 75,600 tokens) with CFG 5 and
    the default negative prompt.  Cut: 1 of the 50 UniPC steps (every step
    costs the same); all 21 latent frames decoded by the streamed decode."""
    return _run_wan(A, "e2e-wan14b", WAN14_COMMAND, "e2e_wan14b", WAN14_STEPS,
                    WAN14_DEPTH, 81, (720, 1280), SHAPE_WAN14["s"],
                    [f"flow.params.scheduler_config.params.num_steps="
                     f"{WAN14_STEPS}"])


def run_e2e_wan1_3b(A) -> dict:
    """Wan 2.1 T2V 1.3B through the registry's ``inference-wanvideo-t2v-1-3B``
    (configs/008_wanvideo/wan2_1_t2v_1_3B.yaml) at full width and depth:
    dim 1536, 30 layers, 12 heads of d=128, bf16, T5-XXL, 81×480×832
    (21×60×104 latents, 32,760 tokens), CFG 5, all 81 frames decoded.
    Cut: ``WAN13_STEPS`` of the 50 UniPC steps."""
    return _run_wan(A, "e2e-wan1.3b", WAN13_COMMAND, "e2e_wan1_3b",
                    WAN13_STEPS, WAN13_DEPTH, 81, (480, 832),
                    SHAPE_WAN13["s"],
                    [f"flow.params.scheduler_config.params.num_steps="
                     f"{WAN13_STEPS}"])


def profile_wan14b_call() -> dict:
    """One full-width Wan 2.1 14B DiT call at 81×720×1280 with CFG (B=2:
    75,600 tokens each, 512 text tokens) under the flow's fixed max, the
    work of one sampling step: timed with CUDA events around the traced
    call, device time by kernel group and the busy share from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    import videotuna_tpu_torch.kernels.attention as A
    _free()
    cfg = load_configs([CONFIG_WAN14])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((2, 21, 90, 160, 16), generator=gen, device="cuda")
    y = torch.randn((2, WAN_TEXT, 4096), generator=gen, device="cuda")
    t = torch.tensor([999.0, 999.0], device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    resident = torch.cuda.memory_allocated()    # the DiT's weights, inputs
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), A.attention_options(static_max=0.0), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        start.record()
        model(x, t, y)
        end.record()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log("profile-wan14b", dit_weights_and_inputs_gb=f"{resident / 1e9:.2f}",
        call_peak_gb=f"{peak / 1e9:.2f}",
        call_transient_gb=f"{(peak - resident) / 1e9:.2f}")
    del model
    _free()
    return _log_profile("profile-wan14b",
                        "one Wan 2.1 14B DiT call, CFG batch 2, 75,600 "
                        "tokens and 512 text tokens each", prof,
                        start.elapsed_time(end), "flash_fwd_sm90 (K3)")


def _narrow_wan():
    """Wan 1.3B at narrow width, d=128 kept: the DiT at dim 256 (2 heads, 2
    layers, ffn 512, bf16 as configured), a 2-layer T5 of dim 64 over the
    config's 512 tokens, the VAE at dim 16."""
    den = "flow.params.denoiser_config.params"
    t5 = "flow.params.cond_stage_config.params"
    return [f"{den}.dim=256", f"{den}.heads=2", f"{den}.num_layers=2",
            f"{den}.ffn_dim=512", f"{den}.text_dim=64", f"{t5}.dim=64",
            f"{t5}.heads=2", f"{t5}.head_dim=32", f"{t5}.ff_dim=128",
            f"{t5}.num_layers=2", "flow.params.first_stage_config.params."
            "dim=16",
            f"flow.params.scheduler_config.params.num_steps={WAN_REF_STEPS}"]


@tf32_off()
def check_small_reference_wan() -> None:
    """The narrow Wan flow (dim 256, 2 heads of d=128, 2 layers, a 2-layer
    T5 over 512 tokens, the VAE at dim 16) on the card and on the CPU with
    the same weights, prompt, negative prompt and x_T, TF32 off: 3×16×16
    latents give 192 tokens, so K3 runs each self-attention (192 × 192) and
    cross-attention (192 × 512) on the card.  One denoiser call, the
    latents after 3 UniPC steps with CFG 5 and the streamed decode of the
    same latents must agree."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.flows.wan import DEFAULT_NEGATIVE
    import videotuna_tpu_torch.kernels.attention as A
    cfg = load_configs([CONFIG_WAN13], _narrow_wan())
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    shape = cpu.latent_shape(1, 9, 128, 128)      # 3×16×16 latents
    x_T = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    t = cpu.scheduler.timesteps[1].reshape(1)
    outs, z_cpu, launches = [], None, {}
    for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
        zero_counts(A)
        cond = flow.encode_text([WAN_PROMPT])
        uncond = flow.encode_text([DEFAULT_NEGATIVE])
        with torch.inference_mode(), flow._attn_scope():
            call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
        z = flow.sample(cond, uncond, shape, None, 5.0, x_T=x_T.to(dev))
        launches = {k: v for k, v in read_counts(A).items() if v}
        z_cpu = z if z_cpu is None else z_cpu
        video = flow.decode_latents(z_cpu.to(dev))
        outs.append([x.float().cpu() for x in (call, z, video)])
    expected = {"K3": 2 * 2 * (1 + WAN_REF_STEPS)}
    if launches != expected:
        raise AssertionError(f"narrow Wan flow on the card launched "
                             f"{launches}, expected {expected}")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    tols = (REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE)
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log("reference-wan", what="narrow wan2_1_t2v_1_3B flow, cuda vs cpu",
        steps=WAN_REF_STEPS, cfg=5.0, card_launches=launches,
        denoiser_call_rel_err=f"{errs[0]:.3e}", call_tol=REF_TOL_CALL,
        latent_rel_err=f"{errs[1]:.3e}", latent_tol=REF_TOL_TRAJ,
        decode_rel_err=f"{errs[2]:.3e}", decode_tol=REF_TOL_DECODE, ok=ok)
    if not ok:
        raise AssertionError("GPU Wan flow disagrees with the CPU flow")
    del cpu, gpu
    _free()


# ------------------------------------------------------ phases 28-32
def check_k1_cog15(A) -> dict:
    """K1 at CogVideoX 1.5's joint attention (B=2 under CFG, 9,674 tokens:
    a ragged last query tile and key tail, H=48, d=64, LayerNormed q and
    k) under the fixed max 0, as the main path runs it, against its plain
    version (a block of query rows at a time); timed by CUDA events and by
    device time beside SDPA, its plain version and its bound."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, s, h = SHAPE_COG15["b"], SHAPE_COG15["s"], SHAPE_COG15["h"]
    q, k, v = _qkv(b, s, s, h, gen)

    def counts():
        return (A.flash_fwd.launches["K1"], A.flash_fwd.launches_sm90["K1"],
                A.flash_fwd.launches_split["K1"], A.flash_fwd.tma_copies)

    before = counts()
    out = _k1(A, q, k, v, 0.0)
    torch.cuda.synchronize()
    launched = counts()
    t0 = time.perf_counter()
    ref, _ = _plain_chunked(A, q, k, v, 0.0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = (err <= K1_TOL * scale and bool(torch.isfinite(out).all())
          and launched == (before[0] + 1, before[1] + 1) + before[2:])
    log("K1-cog15", shape=f"B{b}xS{s}xH{h}xd64", static_max=0.0,
        kernel="flash_fwd_sm90 persistent", last_query_tile=s % 128,
        max_abs_err=f"{err:.3e}", tol=f"{K1_TOL * scale:.3e}",
        plain_ms=f"{plain_ms:.1f}", ok=ok)
    if not ok:
        raise AssertionError("K1 disagrees with its plain version at "
                             "CogVideoX 1.5's shape, or did not launch "
                             "flash_fwd_sm90 in place and unsplit")
    del out, ref
    flops = 4.0 * b * h * s * s * 64
    io_bytes = 4 * q.numel() * q.element_size()
    exp2_ms = _exp2_floor_ms(b * h * s * s)
    bound_ms, bound_by = _bound(flops, io_bytes, exp2_ms)
    ms = cuda_time_ms(lambda: _k1(A, q, k, v, 0.0), reps=10)
    dev_ms = device_ms(lambda: _k1(A, q, k, v, 0.0), 10)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=10)
    log("K1-cog15", timing="flash_fwd_sm90 persistent", ms=f"{ms:.3f}",
        device_ms=f"{dev_ms:.3f}", bound_ms=f"{bound_ms:.3f}",
        bound_by=bound_by, exp2_floor_ms=f"{exp2_ms:.3f}",
        tflops=f"{flops / ms / 1e9:.1f}", of_bound=f"{bound_ms / ms:.3f}",
        plain_ms=f"{plain_ms:.1f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{library_ms:.3f}", vs_library=f"{library_ms / ms:.3f}")
    del q, k, v, qt, kt, vt
    _free()
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def _i2v_inputs(tag: str, size, prompt: str) -> str:
    """An i2v input directory under ``tag``: one seeded PNG at ``size``
    (H, W; a colour gradient with noise) and a one-line prompts.txt."""
    import cv2
    import numpy as np
    path = os.path.join(OUT_DIR, f"{tag}_inputs")
    os.makedirs(path, exist_ok=True)
    h, w = size
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([255 * yy / h, 255 * xx / w, np.full((h, w), 128.0)],
                   axis=-1)
    img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255)
    cv2.imwrite(os.path.join(path, "image.png"), img.astype(np.uint8))
    with open(os.path.join(path, "prompts.txt"), "w") as f:
        f.write(prompt + "\n")
    return path


def _run_cog(A, phase: str, name: str, tag: str, sampled_frames: int,
             tokens: int, i2v: bool) -> dict:
    """One prompt (with its image for i2v) at 49×480×720 through the
    registry's ``name`` at full width and depth (dim 3072, 42 layers, 48
    heads of d=64, bf16; T5-XXL; the CogVideoX VAE in f32), random weights
    from the seed.  Cut as phase 6: 3 of the 50 steps, and the first 4
    kept latent frames decoded.  Asserts K1 = 42 a step, all on
    flash_fwd_sm90 unsplit with no alignment copy, no other launch, the
    sampled and the decoded latent shapes, finite latents and pixels, the
    mp4's frames and metric.json; logs seconds per step, the text and
    image encodes, the decode and the peak memory."""
    from videotuna_tpu_torch.cli.commands import main as command
    savedir = os.path.join(OUT_DIR, tag)
    inputs = ([f"inference.input_dir="
               f"{_i2v_inputs('cog_i2v', (480, 720), COG_PROMPT)}"] if i2v
              else [f"inference.prompt={COG_PROMPT}"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    t0 = time.perf_counter()
    rc = command([name, "--device", "cuda", "--quiet", "--savedir", savedir,
                  f"flow.params.ddim_steps={E2E_STEPS}",
                  f"flow.params.scheduler_config.params.num_steps={E2E_STEPS}",
                  f"inference.decode_latent_frames={DECODE_LATENT_FRAMES}",
                  *inputs])
    wall = time.perf_counter() - t0
    launches = read_counts(A)
    sm90 = read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(savedir, "metric.json")) as f:
        m = json.load(f)
    videos = sorted(p for p in os.listdir(savedir)
                    if p.endswith((".mp4", ".npy")))
    video = _read_video(os.path.join(savedir, videos[0]))
    frames = 1 + 4 * (DECODE_LATENT_FRAMES - 1)
    steps = m["denoise_steps"]
    log(phase, command=name, frames=49, height=480, width=720,
        tokens=tokens, batch="2 (CFG)", steps=steps,
        sec_per_step=f"{m['sample_sec'] / steps:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        image_encode_sec=f"{m['image_encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", run_sec=f"{wall:.1f}",
        peak_mem_gb=f"{peak / 1e9:.2f}",
        k1_per_step=launches["K1"] / max(steps, 1),
        sampled_latent_shape=m["latent_shape"],
        decoded_latent_shape=m["decoded_latent_shape"],
        launches=launches, sm90_launches=sm90,
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    expected = dict({k: 0 for k in launches}, K1=COG_DEPTH * E2E_STEPS)
    if rc != 0 or steps != E2E_STEPS or launches != expected:
        raise AssertionError(f"{phase}: rc {rc}, launches {launches}, "
                             f"expected {expected}: K1 = {COG_DEPTH} blocks "
                             f"× {E2E_STEPS} steps, no other")
    if sm90["K1"] != COG_DEPTH * E2E_STEPS or sm90["tma_copies"]:
        raise AssertionError(f"{phase}: {sm90}: every K1 launch must run "
                             "flash_fwd_sm90, with no alignment copy")
    check_split_counts(phase, sm90)
    if (m["latent_shape"], m["decoded_latent_shape"]) != (
            [1, sampled_frames, 60, 90, 16],
            [1, DECODE_LATENT_FRAMES, 60, 90, 16]):
        raise AssertionError(f"{phase}: sampled {m['latent_shape']}, "
                             f"decoded {m['decoded_latent_shape']}")
    if i2v != (m["image_encode_sec"] > 0):
        raise AssertionError(f"{phase}: image encode {m['image_encode_sec']}")
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError(f"{phase}: non-finite latents or pixels")
    if len(videos) != 1 or tuple(video.shape) != (frames, 480, 720, 3):
        raise AssertionError(f"{phase}: videos {videos}, shape "
                             f"{video.shape}")
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                sec_per_step=m["sample_sec"] / steps,
                text_encode_sec=m["encode_sec"],
                image_encode_sec=m["image_encode_sec"],
                decode_sec=m["decode_sec"])


def run_e2e_cog_i2v(A) -> dict:
    """CogVideoX-5B I2V (configs/004_cogvideox/cogvideo5b_i2v.yaml: 32
    input channels, the cosine dynamic CFG) through the registry's
    ``inference-cogvideo-i2v-diffusers``: 13 latent frames, 226 + 13·30·45
    = 17,776 tokens."""
    return _run_cog(A, "e2e-cog-i2v", COG_I2V_COMMAND, "e2e_cog_i2v", 13,
                    SHAPE_5B["s"], i2v=True)


def run_e2e_cog15_t2v(A) -> dict:
    """CogVideoX 1.5 5B T2V (configs/005_cogvideox1.5/
    cogvideox1.5_5b_t2v.yaml: the (2, 2, 2) patch, 224 text tokens) through
    ``inference-cogvideox-15-5b-t2v``: 14 latent frames sampled, 9,674
    tokens, the first dropped before the decode."""
    return _run_cog(A, "e2e-cog15-t2v", COG15_T2V_COMMAND, "e2e_cog15_t2v",
                    COG15_SAMPLED_FRAMES, SHAPE_COG15["s"], i2v=False)


def run_e2e_cog15_i2v(A) -> dict:
    """CogVideoX 1.5 5B I2V (cogvideox1.5_5b_i2v.yaml) through
    ``inference-cogvideox-15-5b-i2v``, as the T2V run with the image."""
    return _run_cog(A, "e2e-cog15-i2v", COG15_I2V_COMMAND, "e2e_cog15_i2v",
                    COG15_SAMPLED_FRAMES, SHAPE_COG15["s"], i2v=True)


def profile_cog15_call() -> dict:
    """One full-width CogVideoX 1.5 MMDiT call at 49×480×720 with CFG
    (B=2: 14×60×90 latents, 9,674 tokens each with 224 text tokens) under
    the flow's fixed max, the work of one sampling step: timed with CUDA
    events around the traced call, device time by kernel group and the
    busy share from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    import videotuna_tpu_torch.kernels.attention as A
    _free()
    cfg = load_configs([CONFIG_15_T2V])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((2, COG15_SAMPLED_FRAMES, 60, 90, 16), generator=gen,
                    device="cuda")
    y = torch.randn((2, 224, 4096), generator=gen, device="cuda")
    t = torch.tensor([500, 500], device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode(), A.attention_options(static_max=0.0):
        model(x, t, y)     # warm-up: the step's first call is not traced
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            model(x, t, y)
            end.record()
            torch.cuda.synchronize()
    del model
    _free()
    return _log_profile("profile-cog15",
                        "one CogVideoX 1.5 MMDiT call, CFG batch 2, 9,674 "
                        "tokens each", prof, start.elapsed_time(end),
                        "flash_fwd_sm90 (K1)")


@tf32_off()
def check_small_reference_cog15() -> None:
    """The 1.5 I2V flow at narrow width (dim 128, 2 heads of d=64, 2
    layers, the (2, 2, 2) patch, 32 input channels; a 2-layer T5 of dim 64
    over 224 tokens; the VAE at ch 32) on the card and on the CPU with the
    same weights, image, posterior noise, x_T and per-step noise, TF32 off:
    9×96×128 gives 3 latent frames, 4 sampled, so 2·6·8 + 224 = 320 tokens
    and K1 runs each attention on the card.  The image latents, one
    denoiser call, the latents after 3 steps with CFG 6 and the decode of
    the same kept latents must agree."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    import videotuna_tpu_torch.kernels.attention as A
    den = "flow.params.denoiser_config.params"
    t5 = "flow.params.cond_stage_config.params"
    cfg = load_configs([CONFIG_15_I2V], [
        f"{den}.dim=128", f"{den}.heads=2", f"{den}.num_layers=2",
        f"{den}.text_dim=64", f"{t5}.dim=64", f"{t5}.heads=2",
        f"{t5}.head_dim=32", f"{t5}.ff_dim=128", f"{t5}.num_layers=2",
        "flow.params.first_stage_config.params.ch=32",
        "flow.params.first_stage_config.params.num_res_blocks=1",
        f"flow.params.ddim_steps={E2E_STEPS}",
        f"flow.params.scheduler_config.params.num_steps={E2E_STEPS}"])
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    frames, height, width = 9, 96, 128
    shape = cpu.latent_shape(1, frames, height, width)    # 4×12×16
    if shape[1] != 4:
        raise AssertionError(f"1.5 latent shape {shape}: expected 4 frames")
    gen = torch.Generator().manual_seed(2)
    image = torch.rand((1, height, width, 3), generator=gen) * 2 - 1
    post = torch.randn((1, 1, *shape[2:]), generator=gen)
    x_T = torch.randn(shape, generator=gen)
    noises = torch.randn((E2E_STEPS, *shape), generator=gen)
    t = torch.tensor([cpu.scheduler.timesteps[1].item()])
    outs, z_cpu, launches = [], None, {}
    for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
        zero_counts(A)
        cond, uncond = flow.prepare_image_cond(
            flow.encode_text([COG_PROMPT]), flow.encode_text([""]),
            image.to(dev), frames, height, width,
            posterior_noise=post.to(dev))
        with torch.inference_mode(), flow._attn_scope():
            call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
        z = flow.sample(cond, uncond, shape, None, 6.0, x_T=x_T.to(dev),
                        noises=noises.to(dev))
        launches = {k: v for k, v in read_counts(A).items() if v}
        z_cpu = z if z_cpu is None else z_cpu
        video = flow.decode_latents(flow.kept_latents(z_cpu.to(dev), frames))
        outs.append([x.float().cpu() for x in (cond["image_latents"], call,
                                                z, video)])
    expected = {"K1": 2 * (1 + E2E_STEPS)}
    if launches != expected:
        raise AssertionError(f"narrow 1.5 flow on the card launched "
                             f"{launches}, expected {expected}")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    tols = (REF_TOL_DECODE, REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE)
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log("reference-cog15", what="narrow cogvideox1.5_5b_i2v flow, cuda vs "
        "cpu", sampled_latent_shape=list(shape), steps=E2E_STEPS, cfg=6.0,
        card_launches=launches, image_latents_rel_err=f"{errs[0]:.3e}",
        image_latents_tol=REF_TOL_DECODE,
        denoiser_call_rel_err=f"{errs[1]:.3e}", call_tol=REF_TOL_CALL,
        latent_rel_err=f"{errs[2]:.3e}", latent_tol=REF_TOL_TRAJ,
        decode_rel_err=f"{errs[3]:.3e}", decode_tol=REF_TOL_DECODE, ok=ok)
    if not ok:
        raise AssertionError("GPU 1.5 i2v flow disagrees with the CPU flow")
    del cpu, gpu
    _free()


# ------------------------------------------------------ phases 34-40
CONFIG_VC2 = os.path.join(ROOT, "configs", "001_videocrafter2",
                          "vc2_t2v_320x512.yaml")
CONFIG_DC = os.path.join(ROOT, "configs", "002_dynamicrafter",
                         "dc_i2v_576x1024.yaml")
VC2_COMMAND = "inference-vc2-t2v-320x512"
DC_COMMAND = "inference-dc-i2v-576x1024"
VC1_T2V_COMMAND = "inference-vc1-t2v-576x1024"
VC1_I2V_COMMAND = "inference-vc1-i2v-320x512"
WAN_I2V_COMMAND = "inference-wanvideo-i2v-720p"
VC_PROMPT = "a corgi running on a beach at sunset, waves in the background"
VC_FRAMES = 16
VC2_STEPS = 50       # the config's every DDIM step
# of the config's 50 DDIM steps (every step costs the same): cut from 50 to
# keep the script's time while VideoCrafter2's fine-tunes joined it
DC_STEPS = 10
VC1_DDIM_STEPS = 3   # ddim_steps=3: the uniform grid 1000 // 3 gives 4 steps
WAN_I2V_STEPS = 1    # of the config's 50 (2 before the serving phases)
CLIP_LAYERS = 32     # ViT-H/14: one f32 K2 (256 tokens, d=80) a layer
# UNet3D at num_head_channels 64, channel_mult [1, 2, 4, 4], two res blocks
# and attention at ds 1, 2, 4: 5 spatial transformers a level (2 down, 3
# up) and one in the middle, each a self- and a text cross-attention (and
# DynamiCrafter's image cross-attention); level 1 has 5 heads (K2), levels
# 2 and 4 have 10 and 20 (K1), the middle 20 at ds 8, which 320×512 gives
# 40 tokens (the plain math) and 576×1024 144 (K1).  B = 2·16 frames
WAN_I2V_OVERRIDES = [
    "flow.params.i2v_mode=true",
    "flow.params.denoiser_config.params.in_channels=36",
    "flow.params.cond_stage_2_config.target="
    "videotuna_tpu.models.lvdm.CLIPImageEmbedder"]
# K-vc: (label, route, B, Sq, Sk, H, d, dtype); the UNet's attention at
# VideoCrafter2's 320×512 and DynamiCrafter's 576×1024 (B = 32), the CLIP
# image encoder's (f32, d = 80) and Wan I2V's image cross-attention
VC_CASES = [
    ("K2 vc2 self", "K2", 32, 2560, 2560, 5, 64),
    ("K2 dc self", "K2", 32, 9216, 9216, 5, 64),
    ("K2 vc2 cross", "K2", 32, 2560, 77, 5, 64),
    ("K2 dc cross", "K2", 32, 9216, 77, 5, 64),
    ("K1 vc2 ds2 self", "K1", 32, 640, 640, 10, 64),
    ("K1 vc2 ds4 self", "K1", 32, 160, 160, 20, 64),
    ("K1 dc ds2 self", "K1", 32, 2304, 2304, 10, 64),
    ("K1 dc ds4 self", "K1", 32, 576, 576, 20, 64),
    ("K1 vc2 ds2 cross", "K1", 32, 640, 77, 10, 64),
    ("K1 vc2 ds4 cross", "K1", 32, 160, 77, 20, 64),
    ("K1 dc ds2 cross", "K1", 32, 2304, 77, 10, 64),
    ("K1 dc ds4 cross", "K1", 32, 576, 77, 20, 64),
    # DynamiCrafter's middle block (ds 8: 144 tokens, H=20) and its image
    # cross-attention over the resampler's 16 tokens, a key side under one
    # key tile, at every level
    ("K1 dc mid self", "K1", 32, 144, 144, 20, 64),
    ("K1 dc mid cross", "K1", 32, 144, 77, 20, 64),
    ("K2 dc image cross", "K2", 32, 9216, 16, 5, 64),
    ("K1 dc ds2 image cross", "K1", 32, 2304, 16, 10, 64),
    ("K1 dc ds4 image cross", "K1", 32, 576, 16, 20, 64),
    ("K1 dc mid image cross", "K1", 32, 144, 16, 20, 64),
    ("K2 f32 clip", "K2", 1, 256, 256, 16, 80),
    ("K3 wan i2v image cross", "K3", 2, SHAPE_WAN14["s"], 256, 40, 128),
]


def check_k_vc(A) -> dict:
    """The attention of this slice's paths against its plain version, as
    the main paths call it (``flash_attention``: K2 for the UNet's 5-head
    level, K1 for its even-head levels, both online; the CLIP image
    encoder's f32 K2 at d = 80; K3 under the fixed max 0 at Wan I2V's image
    cross-attention), counted per route and per design; each timed by CUDA
    events, by device time (CUDA-graph replay) and beside its bound, its
    plain version (a block of query rows at a time) and SDPA; K2 at d = 64
    also beside the old design (flash_fwd.cu, ``_flash_fwd_mma``) on the
    same tensors, which the Hopper design must not lose to at the
    self-attention shapes."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    gen = torch.Generator(device="cuda").manual_seed(14)
    recs = {}
    for label, route, b, sq, sk, h, d in VC_CASES:
        f32 = d == 80
        static_max = 0.0 if route == "K3" else None
        if route == "K3":
            q, k, v = _wan_qkv(b, sq, sk, h, gen)
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda")
                       for s in (sq, sk, sk))
            if not f32:
                q, k, v = (x.bfloat16() for x in (q, k, v))
        design = A._fwd_design(route, q.dtype, d, False, None, False,
                               static_max)

        def call():
            return A.flash_attention(q, k, v, static_max=static_max)

        splits = (A._fwd_plan(design, q, k, False, False).splits
                  if design != "mma" else 1)
        before = (A.flash_fwd.launches[route],
                  A.flash_fwd.launches_sm90[route],
                  A.flash_fwd.launches_split[route], A.flash_fwd.tma_copies)
        out = call()
        torch.cuda.synchronize()
        launched = (A.flash_fwd.launches[route],
                    A.flash_fwd.launches_sm90[route],
                    A.flash_fwd.launches_split[route], A.flash_fwd.tma_copies)
        t0 = time.perf_counter()
        # query rows a block of the plain version: about 2 GB of f32 scores
        rows = max(128, min(4096, int(2e9 / (4 * b * h * sk)) // 128 * 128))
        ref = torch.cat([A.flash_fwd_plain(q[:, i:i + rows], k, v,
                                           sm_scale=d ** -0.5,
                                           static_max=static_max)
                         for i in range(0, sq, rows)], dim=1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = (F32_TOL if f32 else FWD_TOL) * scale
        expected = (before[0] + 1, before[1] + (design == "sm90"),
                    before[2] + (splits > 1), before[3])
        ok = (err <= tol and bool(torch.isfinite(out).all())
              and launched == expected
              and design == ("f32" if f32 else "sm90"))
        kernel = ("flash_fwd_sm90" if design == "sm90"
                  else "flash_fwd_f32_sm90")
        log("K-vc", case=label, shape=f"B{b}xSq{sq}xSk{sk}xH{h}xd{d}",
            route=route, kernel=kernel, dtype=str(q.dtype)[6:],
            static_max=static_max, max_abs_err=f"{err:.3e}",
            tol=f"{tol:.3e}", plain_ms=f"{plain_ms:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"K-vc {label}: disagrees with its plain "
                                 f"version, or launched {launched} on "
                                 f"{design} (expected {expected})")
        del out, ref
        flops = 4.0 * b * h * sq * sk * d
        io_bytes = q.element_size() * (2 * q.numel() + k.numel()
                                       + v.numel())
        # the exp2 floor counts for the bf16 kernels (one exp2 a score);
        # the f32 kernel splits each product into three bf16 ones
        exp2_ms = 0.0 if f32 else _exp2_floor_ms(b * h * sq * sk)
        bound_ms, bound_by = _bound(3 * flops if f32 else flops, io_bytes,
                                    exp2_ms)
        reps = 3 if flops > 1e12 else 20
        ms = cuda_time_ms(call, reps=reps)
        dev = device_ms(call, 10)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms, backend = sdpa_ms((qt, kt, vt), {}, reps=reps)
        library_dev, _ = sdpa_device_ms((qt, kt, vt), {}, 10)
        del qt, kt, vt
        rec = dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, library_device_ms=library_dev)
        extra = {}
        if route == "K2" and not f32:
            # the A/B baseline the rule replaced, on the same tensors, in
            # turns with the Hopper design
            def old():
                return A._flash_fwd_mma(q, k, v, d ** -0.5, False, None,
                                        None, False)
            old_ms = cuda_time_ms(old, reps=reps)
            rec["old_design_ms"] = old_ms
            rec["old_design_device_ms"] = device_ms(old, 10)
            rec["ms_again"] = cuda_time_ms(call, reps=reps)
            extra = dict(old_design_ms=f"{old_ms:.4f}",
                         old_design_device_ms=(
                             f"{rec['old_design_device_ms']:.4f}"),
                         ms_again=f"{rec['ms_again']:.4f}")
            if sq == sk and min(ms, rec["ms_again"]) > old_ms:
                raise AssertionError(f"K-vc {label}: the Hopper design "
                                     f"({ms:.4f} ms) loses to flash_fwd.cu "
                                     f"({old_ms:.4f} ms)")
        log("K-vc", case=f"{label} timing", kernel=kernel, ms=f"{ms:.4f}",
            device_ms=f"{dev:.4f}", **extra, bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, tflops=f"{flops / ms / 1e9:.1f}",
            of_bound=f"{bound_ms / ms:.3f}", plain_ms=f"{plain_ms:.1f}",
            library=f"scaled_dot_product_attention[{backend}]",
            library_ms=f"{library_ms:.4f}",
            library_device_ms=f"{library_dev:.4f}",
            vs_library=f"{library_ms / ms:.3f}")
        recs[label] = rec
        del q, k, v
        _free()
    return recs


def _unet_launches(size, image_cross: bool):
    """(K2, K1) launches of one UNet3D call (B = 2·16) at ``size`` (H, W):
    level 1's 5 spatial transformers on K2, levels 2 and 4 and, from 128
    tokens on, the middle on K1; each a self- and a text cross-attention,
    DynamiCrafter's an image cross-attention too."""
    per = 3 if image_cross else 2
    h, w = size[0] // 8, size[1] // 8
    mid = (h // 8) * (w // 8) >= 128
    return 5 * per, (10 + mid) * per


def _run_vc(A, phase: str, name: str, tag: str, steps: int, size,
            i2v: bool, image_cross: bool, clip: bool,
            extra=()) -> dict:
    """One prompt (with its image for i2v) through the registry's ``name``
    at full width and depth (UNet3D at model_channels 320, channel_mult
    [1, 2, 4, 4], 64-wide heads, bf16; OpenCLIP-H text over 77 tokens; the
    2D VAE; for DynamiCrafter the CLIP ViT-H/14 image encoder and the
    resampler), random weights from the seed, 16 frames with CFG, every
    frame decoded.  Asserts the launches per step (``_unet_launches``), all
    on flash_fwd_sm90 unsplit with no alignment copy, the CLIP image
    encoder's 32 f32 K2 on the split f32 design, no other launch, finite
    latents
    and pixels, the mp4's frames and metric.json; logs seconds per step,
    the text and image encodes, the decode and the peak memory."""
    from videotuna_tpu_torch.cli.commands import main as command
    savedir = os.path.join(OUT_DIR, tag)
    inputs = ([f"inference.input_dir={_i2v_inputs(tag, size, VC_PROMPT)}"]
              if i2v else [f"inference.prompt={VC_PROMPT}"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    t0 = time.perf_counter()
    rc = command([name, "--device", "cuda", "--quiet", "--savedir", savedir,
                  f"flow.params.ddim_steps={steps}", *extra, *inputs])
    wall = time.perf_counter() - t0
    launches = read_counts(A)
    sm90 = read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(savedir, "metric.json")) as f:
        m = json.load(f)
    videos = sorted(p for p in os.listdir(savedir)
                    if p.endswith((".mp4", ".npy")))
    video = _read_video(os.path.join(savedir, videos[0]))
    n = m["denoise_steps"]
    k2, k1 = _unet_launches(size, image_cross)
    h, w = size
    log(phase, command=name, frames=VC_FRAMES, height=h, width=w,
        tokens_level1=(h // 8) * (w // 8), batch="2x16 (CFG)", steps=n,
        sec_per_step=f"{m['sample_sec'] / n:.4f}",
        sample_sec=f"{m['sample_sec']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        image_encode_sec=f"{m['image_encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", run_sec=f"{wall:.1f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", k2_per_step=k2, k1_per_step=k1,
        launches=launches, sm90_launches=sm90,
        sampled_latent_shape=m["latent_shape"],
        nonfinite_latents=m["nonfinite_latents"],
        nonfinite_pixels=m["nonfinite_pixels"],
        video_shape="x".join(map(str, video.shape)))
    clip_k2 = CLIP_LAYERS if clip else 0
    expected = dict({k: 0 for k in launches}, K2=k2 * n + clip_k2,
                    K1=k1 * n)
    if rc != 0 or launches != expected:
        raise AssertionError(f"{phase}: rc {rc}, launches {launches}, "
                             f"expected {expected}")
    if (sm90["K2"], sm90["K1"], sm90["tma_copies"]) != (k2 * n, k1 * n, 0):
        raise AssertionError(f"{phase}: {sm90}: every UNet K2 and K1 launch "
                             "must run flash_fwd_sm90, with no alignment "
                             "copy (the CLIP encoder's f32 K2 the f32 "
                             "design)")
    check_split_counts(phase, sm90, clip=clip_k2)
    if m["latent_shape"] != [1, VC_FRAMES, h // 8, w // 8, 4]:
        raise AssertionError(f"{phase}: sampled {m['latent_shape']}")
    if i2v != (m["image_encode_sec"] > 0):
        raise AssertionError(f"{phase}: image encode {m['image_encode_sec']}")
    if m["nonfinite_latents"] or m["nonfinite_pixels"]:
        raise AssertionError(f"{phase}: non-finite latents or pixels")
    if len(videos) != 1 or tuple(video.shape) != (VC_FRAMES, h, w, 3):
        raise AssertionError(f"{phase}: videos {videos}, shape "
                             f"{video.shape}")
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9, steps=n,
                sec_per_step=m["sample_sec"] / n,
                sample_sec=m["sample_sec"], text_encode_sec=m["encode_sec"],
                image_encode_sec=m["image_encode_sec"],
                decode_sec=m["decode_sec"])


def run_e2e_vc2(A) -> dict:
    """VideoCrafter2 T2V (configs/001_videocrafter2/vc2_t2v_320x512.yaml:
    v-prediction, zero terminal SNR) through ``inference-vc2-t2v-320x512``
    whole: 16×320×512, all 50 DDIM steps, CFG 12, every frame decoded."""
    return _run_vc(A, "e2e-vc2", VC2_COMMAND, "e2e_vc2", VC2_STEPS,
                   (320, 512), False, False, False)


def run_e2e_dc(A) -> dict:
    """DynamiCrafter I2V (configs/002_dynamicrafter/dc_i2v_576x1024.yaml:
    8 input channels, the image cross-attention) through
    ``inference-dc-i2v-576x1024`` from one seeded 1024×576 PNG:
    16×576×1024, all 50 DDIM steps, CFG 7.5, every frame decoded."""
    return _run_vc(A, "e2e-dc", DC_COMMAND, "e2e_dc", DC_STEPS, (576, 1024),
                   True, True, True)


def run_e2e_vc1(A) -> list:
    """VideoCrafter1 T2V at 576×1024 (relative positions in the temporal
    attention, no temporal conv) and I2V at 320×512 (the CLIP image
    embedder's tokens, which its UNet does not read: ROADMAP.md queue 3),
    each 16 frames, cut to ddim_steps 3 (4 steps on the uniform grid)."""
    return [_run_vc(A, "e2e-vc1-t2v", VC1_T2V_COMMAND, "e2e_vc1_t2v",
                    VC1_DDIM_STEPS, (576, 1024), False, False, False),
            _run_vc(A, "e2e-vc1-i2v", VC1_I2V_COMMAND, "e2e_vc1_i2v",
                    VC1_DDIM_STEPS, (320, 512), True, False, True)]


def run_e2e_wan_i2v(A) -> dict:
    """Wan 2.1 I2V-14B through the registry's ``inference-wanvideo-i2v-720p``
    with the layout its config lacks as overrides (i2v_mode, in_dim 36,
    cond_stage_2 the CLIP ViT-H/14 image embedder: ROADMAP.md queue 3), at
    full width and depth from one seeded 1280×720 PNG: 81×720×1280, 1 of 50
    steps, all frames decoded by the streamed decode.  Each layer runs K3
    three times a step: self-, text cross- and image cross-attention (256
    CLIP tokens); the CLIP encoder its 32 f32 K2."""
    inputs = _i2v_inputs("e2e_wan_i2v", (720, 1280), WAN_PROMPT)
    return _run_wan(A, "e2e-wan-i2v", WAN_I2V_COMMAND, "e2e_wan_i2v",
                    WAN_I2V_STEPS, WAN14_DEPTH, 81, (720, 1280),
                    SHAPE_WAN14["s"],
                    [f"flow.params.scheduler_config.params.num_steps="
                     f"{WAN_I2V_STEPS}", f"inference.input_dir={inputs}",
                     *WAN_I2V_OVERRIDES], attn_per_layer=3,
                    clip_k2=CLIP_LAYERS)


def _narrow_vc(dc: bool):
    """VideoCrafter2 (or DynamiCrafter) at narrow width, 64-wide heads
    kept: the UNet at model_channels 64 (1 head at level 1: K2; 2 and 4 at
    levels 2 and 4: K1), one res block a level, in f32, a 2-layer CLIP text
    encoder of dim 64, the VAE at ch 32; DynamiCrafter's CLIP image encoder
    at dim 160 (2 heads of d = 80: the f32 K2 over 256 tokens), 2 layers,
    and a 1-layer resampler.  The UNet runs in f32: in bf16 its rounding
    alone moved one card call by up to 2.4e-2 of max|out| against the CPU,
    and the latents by 1.0e-1, at ``REF_TOL_CALL`` and ``REF_TOL_TRAJ``:
    too close for a card-vs-CPU check to tell a fault."""
    u = "flow.params.denoiser_config.params"
    c = "flow.params.cond_stage_config.params"
    out = [f"{u}.model_channels=64", f"{u}.num_res_blocks=1",
           f"{u}.dtype=float32", f"{u}.context_dim=64", f"{c}.dim=64",
           f"{c}.heads=2",
           f"{c}.num_layers=2", "flow.params.first_stage_config.params.ch=32",
           "flow.params.first_stage_config.params.num_res_blocks=1",
           f"flow.params.ddim_steps={E2E_STEPS}"]
    if dc:
        i = "flow.params.cond_stage_2_config.params"
        out += [f"{i}.clip_dim=160", f"{i}.clip_heads=2",
                f"{i}.clip_layers=2", f"{i}.dim=64", f"{i}.depth=1",
                f"{i}.heads=2", f"{i}.output_dim=64"]
    return out


@tf32_off()
def check_small_reference_vc(control: float = 0.0) -> None:
    """VideoCrafter2 and DynamiCrafter at narrow width (``_narrow_vc``, in
    f32) on the card and on the CPU with the same weights, prompt, image,
    posterior noise and x_T, TF32 off: 4×128×256 frames give 16×32
    latents, 512 tokens at level 1 (K2, 1 head) and 128 at level 2 (K1),
    so flash_fwd.cu's f32 path runs each of those attentions on the card
    (level 4's 32 tokens and the middle take the plain math on both; the
    bf16 Hopper kernels of the full-size runs are held to their plain
    versions in K-vc).  DynamiCrafter's image tokens and latent, one UNet
    call, the latents after the DDIM steps with CFG (ddim_steps 3: 4 steps
    on the uniform grid) and the decode of the same latents must agree.

    With ``control`` > 0, the control of the check itself: VideoCrafter2
    alone, every card attention output scaled by 1 + ``control``, and the
    check must then fail."""
    import videotuna_tpu_torch.kernels.attention as A
    flash = A.flash_attention

    def scaled(*args, **kwargs):
        out = flash(*args, **kwargs)
        return out * (1 + control) if out.is_cuda else out

    if control:
        A.flash_attention = scaled
    try:
        _reference_vc(A, control)
    finally:
        A.flash_attention = flash


def _reference_vc(A, control: float) -> None:
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    frames, height, width = 4, 128, 256
    flows = ((False, CONFIG_VC2),) + (() if control else ((True, CONFIG_DC),))
    for dc, path in flows:
        cfg = load_configs([path], _narrow_vc(dc))
        cpu = instantiate(cfg["flow"], device="cpu")
        gpu = instantiate(cfg["flow"], device="cuda")
        cpu.init_params(seed=1)
        for name, module in cpu.components().items():
            gpu.components()[name].load_state_dict(module.state_dict())
        shape = cpu.latent_shape(1, frames, height, width)
        gen = torch.Generator().manual_seed(2)
        image = torch.rand((1, height, width, 3), generator=gen) * 2 - 1
        post = torch.randn((1, 1, *shape[2:]), generator=gen)
        x_T = torch.randn(shape, generator=gen)
        t = torch.tensor([int(cpu.scheduler.timesteps[1])])
        outs, z_cpu, launches = [], None, {}
        for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
            zero_counts(A)
            cond = flow.encode_text([VC_PROMPT])
            uncond = flow.encode_text([""])
            if dc:
                cond, uncond = flow.prepare_image_cond(
                    cond, uncond, image.to(dev), frames, height, width,
                    posterior_noise=post.to(dev))
            with torch.inference_mode():
                call = flow.denoise_apply(x_T.to(dev), t.to(dev), cond)
            z = flow.sample(cond, uncond, shape, None, 7.5, x_T=x_T.to(dev))
            launches = {k: v for k, v in read_counts(A).items() if v}
            z_cpu = z if z_cpu is None else z_cpu
            video = flow.decode_latents(z_cpu.to(dev))
            outs.append([x.float().cpu() for x in (
                [cond["context_img"], cond["img_latents"]] if dc else [])
                + [call, z, video]])
        # a call and CFG's steps (B = 2): level 1's 3 spatial transformers
        # on K2, level 2's on K1; each a self- and a text cross-attention
        # (DynamiCrafter an image cross-attention too); DynamiCrafter's
        # image conditioning adds 3 f32 K2: the CLIP encoder's 2 layers and
        # the VAE encoder's middle attention (one head of d=128 over 512
        # tokens)
        per = 3 if dc else 2
        calls = 1 + gpu.scheduler.num_steps
        expected = {"K2": 3 * per * calls + 3 * dc, "K1": 3 * per * calls}
        if launches != expected:
            raise AssertionError(f"narrow {'DC' if dc else 'VC2'} flow on "
                                 f"the card launched {launches}, expected "
                                 f"{expected}")

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()

        errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
        tols = ((REF_TOL_DECODE,) * 2 if dc else ()) + (
            REF_VC_TOL_CALL, REF_VC_TOL_TRAJ, REF_TOL_DECODE)
        ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
        log("reference-vc", what=f"narrow {os.path.basename(path)} flow, "
            "cuda vs cpu", control=control, latent_shape=list(shape),
            steps=gpu.scheduler.num_steps, cfg=7.5, card_launches=launches,
            rel_errs=[f"{e:.3e}" for e in errs], tols=list(tols), ok=ok)
        if control and ok:
            raise AssertionError(f"reference-vc passed with every card "
                                 f"attention output scaled by 1 + {control}")
        if not control and not ok:
            raise AssertionError("GPU VideoCrafter flow disagrees with the "
                                 "CPU flow")
        del cpu, gpu
        _free()


def profile_dc_call() -> dict:
    """One full-width DynamiCrafter UNet call at 16×576×1024 with CFG (B =
    2·16 frames of 72×128 latents, 8 input channels, 77 text and 16 image
    tokens), the work of one sampling step: timed with CUDA events around
    the traced call, device time by kernel group (the flash kernels, GEMMs,
    convolutions, GroupNorm, the rest) and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    _free()
    cfg = load_configs([CONFIG_DC])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((2, VC_FRAMES, 72, 128, 8), generator=gen, device="cuda")
    y = torch.randn((2, 77, 1024), generator=gen, device="cuda")
    img = torch.randn((2, 16, 1024), generator=gen, device="cuda")
    t = torch.tensor([500, 500], device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        model(x, t, y, img)     # warm-up: the first call is not traced
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            model(x, t, y, img)
            end.record()
            torch.cuda.synchronize()
    log("profile-dc", call_peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del model
    _free()
    return _log_profile("profile-dc",
                        "one DynamiCrafter UNet3D call, CFG batch 2x16 "
                        "frames, 9,216 tokens at level 1", prof,
                        start.elapsed_time(end), "flash_fwd (K2, K1)",
                        extra_groups=_UNET_GROUPS)


# kernel groups of a UNet trace beside the flash kernels and the GEMMs,
# matched (lower case) before them: cuDNN's convolutions and PyTorch's
# GroupNorm kernels
_UNET_GROUPS = (("conv", ("conv", "fprop", "implicit_convolve", "winograd")),
                ("group_norm", ("group_norm", "groupnorm", "rowwisemoments",
                                "computefusedparams", "moments")))


# ---------------------------------------------------------------- VC2 training
# VideoCrafter2 fine-tuning through the registry's commands at the config's
# 16×320×512, batch 1 (B = 16 frames in the spatial attention), dummy video
VC2_TRAIN_COMMAND = "train-videocrafter-v2"
VC2_LORA_COMMAND = "train-videocrafter-lora"
VC2_TRAIN_FRAMES = 16
VC2_TRAIN_SIZE = (320, 512)
# the attention of one training step, as the JAX package's `_fa_fwd` routes
# it (:1939): K1 with the LSE where the heads pair and both sides are ≥ 128
# tokens, else K5; the backward K7 for an even head count (the JAX
# `flash_attention_bwd`'s packed pair, :1737), else K8.  Level 1 (5 heads):
# 5 self-attentions (K5, K8) and 5 over the 77 text keys (K5, K8); levels 2
# and 4 (10, 20 heads): 10 self (K1, K7), 10 cross (K5, K7); the middle's
# 40 tokens and the temporal attention's 16 frames take the plain math
VC2_TRAIN_PER_STEP = {"K5": 20, "K1": 10, "K8": 10, "K7": 20, "K2": 0,
                      "K3": 0, "K4": 0, "K6": 0, "K9": 0, "K10": 0}
# of those backwards, the cross-attentions' over 77 keys (one key tile) run
# flash_bwd_rows_sm90 (``_bwd_kernel``): 5 K8 and 10 K7 a step
VC2_TRAIN_ROWS_PER_STEP = {"K8": 5, "K7": 10}
# K-vct: (label, forward route, Sq, Sk, H) at B = 16, d = 64, bf16
VCT_CASES = [
    ("self", "K5", 2560, 2560, 5),
    ("cross", "K5", 2560, 77, 5),
    ("ds2 self", "K1", 640, 640, 10),
    ("ds2 cross", "K5", 640, 77, 10),
    ("ds4 self", "K1", 160, 160, 20),
    ("ds4 cross", "K5", 160, 77, 20),
]
VCT_B = 16
# train-reference-vc's control: every card attention output of the narrow
# training step scaled by 1 + this must fail the check
VCT_CONTROL = 5e-2


def _fwd_vct(A, label, route, q, k, v, rec_out) -> tuple:
    """One training forward (``flash_fwd`` with the LSE on ``route``)
    against the plain version, counted on the route and the Hopper design,
    timed beside its bound, the plain version, SDPA and the old design
    (flash_fwd.cu); returns (o, lse)."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sm = d ** -0.5

    def fwd():
        return A.flash_fwd(q, k, v, sm_scale=sm, emit_lse=True, route=route)

    def counts():
        return (A.flash_fwd.launches[route], A.flash_fwd.launches_sm90[route],
                A.flash_fwd.launches_split[route], A.flash_fwd.tma_copies)

    design = A._fwd_design(route, q.dtype, d, False, None, True, None)
    before = counts()
    out, lse = fwd()
    torch.cuda.synchronize()
    launched = counts()
    t0 = time.perf_counter()
    ref, ref_lse = _plain_chunked(A, q, k, v, None)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out.float() - ref.float()).abs().max().item()
    tol = FWD_TOL * ref.float().abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    expected = (before[0] + 1, before[1] + 1, before[2], before[3])
    ok = (design == "sm90" and err <= tol and lse_err <= LSE_TOL
          and launched == expected)
    del ref, ref_lse
    flops = 4.0 * b * h * sq * sk * d
    io_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    bound_ms, bound_by = _bound(flops, io_bytes,
                                _exp2_floor_ms(b * h * sq * sk))
    old = lambda: A._flash_fwd_mma(q, k, v, sm, False, None, None, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    rec = dict(max_abs_err=err, lse_err=lse_err, ms=cuda_time_ms(fwd, 20),
               device_ms=device_ms(fwd, 10), plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               old_design_ms=cuda_time_ms(old, 20),
               old_design_device_ms=device_ms(old, 10))
    rec["library_ms"], backend = sdpa_ms((qt, kt, vt), {}, reps=20)
    rec["library_device_ms"], _ = sdpa_device_ms((qt, kt, vt), {}, 10)
    del qt, kt, vt
    log("K-vct", case=f"{route} {label}",
        shape=f"B{b}xSq{sq}xSk{sk}xH{h}xd{d}", kernel="flash_fwd_sm90"
        if design == "sm90" else "flash_fwd", emit_lse=True,
        max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}", lse_err=f"{lse_err:.3e}",
        lse_tol=LSE_TOL, ms=f"{rec['ms']:.4f}",
        device_ms=f"{rec['device_ms']:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        of_bound=f"{bound_ms / rec['device_ms']:.3f}",
        plain_ms=f"{plain_ms:.1f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{rec['library_ms']:.4f}",
        library_device_ms=f"{rec['library_device_ms']:.4f}",
        old_design="flash_fwd.cu", old_design_ms=f"{rec['old_design_ms']:.4f}",
        old_design_device_ms=f"{rec['old_design_device_ms']:.4f}", ok=ok)
    if not ok:
        raise AssertionError(f"K-vct {route} {label}: disagrees with its "
                             f"plain version, or launched {launched} on "
                             f"{design} (expected {expected} on sm90)")
    rec_out[f"{route} {label}"] = rec
    return out, lse


def _bwd_vct(A, label, q, k, v, out, lse, g, rec_out) -> None:
    """The backward of a training forward (``flash_bwd``: K7 for an even
    head count, else K8) against the plain backward, counted on the route,
    the Hopper design and the kernel ``_bwd_kernel`` names, timed beside
    its bound, the plain version, SDPA's backward (forward plus backward
    minus forward) and the old design (flash_bwd.cu); over one key tile,
    where the short-row kernel (flash_bwd_rows_sm90.cu, its 16-column box
    past d = 64) runs, also flash_bwd_sm90 as the other Hopper design, held
    to the same plain backward: the rule's A/B."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sm = d ** -0.5
    route = "K7" if h % 2 == 0 else "K8"
    rows = A._bwd_kernel(d, sk) == "rows"

    def bwd():
        return A.flash_bwd(q, k, v, out, g, lse, sm_scale=sm)

    def counts():
        return (A.flash_bwd.launches[route], A.flash_bwd.launches_sm90[route],
                A.flash_bwd.launches_d128[route],
                A.flash_bwd.launches_rows[route])

    design = A._bwd_design(route, q.dtype, d, False, False)
    before = counts()
    got = bwd()
    torch.cuda.synchronize()
    launched = counts()
    t0 = time.perf_counter()
    ref = _bwd_plain_chunked(A, q, k, v, out, g, lse, sm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, ok, errs = _bwd_errs(got, ref)
    _, old_ok, old_errs = _bwd_errs(
        A._flash_bwd_mma(q, k, v, out, g, lse, sm), ref)
    other = (lambda: A._flash_bwd_sm90(q, k, v, out, g, lse, sm)) \
        if rows else None
    other_errs = None
    if other is not None:
        _, other_ok, other_errs = _bwd_errs(other(), ref)
        old_ok = old_ok and other_ok
    expected = (before[0] + 1, before[1] + 1, before[2], before[3] + rows)
    ok = ok and design == "sm90" and launched == expected
    del got, ref
    flops = 10.0 * b * h * sq * sk * d
    io_bytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    bound_ms, bound_by = _bound(flops, io_bytes,
                                _exp2_floor_ms(b * h * sq * sk))
    old = lambda: A._flash_bwd_mma(q, k, v, out, g, lse, sm)
    kernel = "flash_bwd_rows_sm90" if rows else "flash_bwd_sm90"
    rec = dict(max_abs_err=err, kernel=kernel, ms=cuda_time_ms(bwd, 20),
               device_ms=device_ms(bwd, 10), plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               old_design_ms=cuda_time_ms(old, 20),
               old_design_device_ms=device_ms(old, 10))
    extra = {}
    if other is not None:
        rec.update(other_design_ms=cuda_time_ms(other, 20),
                   other_design_device_ms=device_ms(other, 10),
                   ms_again=cuda_time_ms(bwd, 20))
        extra = dict(other_design="flash_bwd_sm90",
                     other_design_errs=",".join(other_errs),
                     other_design_ms=f"{rec['other_design_ms']:.4f}",
                     other_design_device_ms=(
                         f"{rec['other_design_device_ms']:.4f}"),
                     ms_again=f"{rec['ms_again']:.4f}")
    rec["library_ms"], backend = sdpa_bwd_ms(q, k, v, g, reps=20)
    rec["library_device_ms"], dev_backend = sdpa_bwd_device_ms(q, k, v, g,
                                                               10)
    log("K-vct", case=f"{route} {label}",
        shape=f"B{b}xSq{sq}xSk{sk}xH{h}xd{d}",
        kernel=kernel if design == "sm90" else "flash_bwd",
        dq=errs[0], dk=errs[1], dv=errs[2], ms=f"{rec['ms']:.4f}",
        device_ms=f"{rec['device_ms']:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, of_bound=f"{bound_ms / rec['device_ms']:.3f}",
        plain_ms=f"{plain_ms:.1f}",
        library=f"sdpa backward[{backend}], device [{dev_backend}]",
        library_ms=f"{rec['library_ms']:.4f}",
        library_device_ms=f"{rec['library_device_ms']:.4f}",
        old_design="flash_bwd.cu", old_design_ms=f"{rec['old_design_ms']:.4f}",
        old_design_device_ms=f"{rec['old_design_device_ms']:.4f}",
        old_design_errs=",".join(old_errs), **extra, ok=ok and old_ok)
    if not ok:
        raise AssertionError(f"K-vct {route} {label}: disagrees with the "
                             f"plain backward, or launched {launched} on "
                             f"{design} (expected {expected} on {kernel})")
    if not old_ok:
        raise AssertionError(f"K-vct {route} {label}: an A/B design "
                             "disagrees with the plain backward")
    rec_out[f"{route} {label}"] = rec


def check_k_vct(A) -> dict:
    """The attention of a VideoCrafter2 training step (``VCT_CASES``: B =
    16 frames, d = 64, bf16): each training forward with its LSE and its
    backward on that forward's output, as the custom VJP runs them, against
    their plain versions (forward ``FWD_TOL`` of max|o| and ``LSE_TOL``;
    backward ``BWD_TOL`` of each gradient's max), counted per route and
    design; each timed by CUDA events and device time beside its bound, its
    plain version, SDPA and the old design."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    recs = {}
    for label, route, sq, sk, h in VCT_CASES:
        q = torch.randn((VCT_B, sq, h, 64), generator=gen, device="cuda")
        k, v = (torch.randn((VCT_B, sk, h, 64), generator=gen,
                            device="cuda") for _ in range(2))
        g = torch.randn((VCT_B, sq, h, 64), generator=gen, device="cuda")
        q, k, v, g = (x.bfloat16() for x in (q, k, v, g))
        out, lse = _fwd_vct(A, label, route, q, k, v, recs)
        _bwd_vct(A, label, q, k, v, out, lse, g, recs)
        del q, k, v, g, out, lse
        _free()
    return recs


def _vc2_train_argv(command: str, tag: str, extra=()):
    """The registry's ``command`` line with this run's: dummy video at
    16×320×512, ``TRAIN_STEPS`` steps, a log line each."""
    from videotuna_tpu_torch.cli.commands import COMMANDS
    cmd = COMMANDS[command]
    argv = []
    for cfg in cmd.configs:
        argv += ["--config", cfg]
    return argv + [
        "--device", "cuda", "--quiet", "--max_steps", str(TRAIN_STEPS),
        "--workdir", os.path.join(OUT_DIR, tag)] + cmd.overrides + [
        _dummy_data(VC2_TRAIN_FRAMES, *VC2_TRAIN_SIZE),
        f"train.ckpt_every={TRAIN_STEPS}", "train.log_every=1", *extra]


def _fingerprint(module) -> dict:
    """Each parameter's f32 sum, on the card: equal for equal weights."""
    with torch.no_grad():
        return {n: p.float().sum().item() for n, p in
                module.named_parameters()}


def _check_vc2_sm90(tag: str, out: dict) -> None:
    """Every launch of a VideoCrafter2 training run on a Hopper design at
    d = 64: K1 and K5 on flash_fwd_sm90, K7 and K8 on flash_bwd_sm90 but
    the cross-attentions' on flash_bwd_rows_sm90; no forward alignment
    copy, no split."""
    sm90 = out["sm90"]
    hopper = {k: sm90[k] for k in ("K1", "K5", "K7", "K8", "K7_rows",
                                   "K8_rows")}
    want = dict({k: VC2_TRAIN_PER_STEP[k] * TRAIN_STEPS
                 for k in ("K1", "K5", "K7", "K8")},
                **{f"{k}_rows": n * TRAIN_STEPS
                   for k, n in VC2_TRAIN_ROWS_PER_STEP.items()})
    log(tag, bwd_tma_copies=sm90["bwd_tma_copies"])
    if hopper != want or sm90["K5_d128"] or sm90["K8_d128"] \
            or sm90["tma_copies"]:
        raise AssertionError(f"{tag}: {sm90}: every K1 and K5 launch must "
                             "run flash_fwd_sm90 and every K7 and K8 launch "
                             "flash_bwd_sm90, or over 77 keys "
                             f"flash_bwd_rows_sm90, at d=64 ({want}), with "
                             "no forward alignment copy")
    check_split_counts(tag, sm90)


def run_train_vc2(A) -> dict:
    """VideoCrafter2's full fine-tune (UNet3D 1.41B, bf16 weights with f32
    masters, AdamW, EMA 0.9999, clip 1) through the registry's
    ``train-videocrafter-v2``, 3 steps on dummy video at 16×320×512; then
    ``save_pretrained`` of the trained UNet, which the LoRA run loads.
    The trainer's own checkpoint, the 22.6 GB train state (f32 masters,
    both Adam moments, the EMA), is not written: the card's machine takes
    45 GiB of disk writes a run, which the earlier phases' checkpoints
    nearly fill (a full fine-tune's save and resume run in train-stdit).
    Its save still binds the masters into the module, as ``Trainer.save``
    does."""
    pretrained = {}

    def bind_only(trainer):
        def save(state, step):
            trainer._bind(state.params)
        trainer.save = save

    def save(trainer):
        t0 = time.perf_counter()
        step_dir = trainer.flow.save_pretrained(
            os.path.join(OUT_DIR, "vc2_pretrained"), step=TRAIN_STEPS,
            only_trained=True)
        pretrained.update(dir=step_dir,
                          fingerprint=_fingerprint(trainer.flow.denoiser))
        log("train-vc2", save_pretrained=step_dir,
            files=",".join(sorted(os.listdir(step_dir))),
            seconds=f"{time.perf_counter() - t0:.1f}")

    _free()
    log("train-vc2", command=VC2_TRAIN_COMMAND, frames=VC2_TRAIN_FRAMES,
        height=VC2_TRAIN_SIZE[0], width=VC2_TRAIN_SIZE[1], batch=1,
        remat=False, cut="none (full width, depth and frames)")
    out = _train_run(A, "train-vc2",
                     _vc2_train_argv(VC2_TRAIN_COMMAND, "train_vc2"),
                     VC2_TRAIN_PER_STEP, lora=False, resume=False,
                     on_built=bind_only, on_fit=save, saves=False)
    _check_vc2_sm90("train-vc2", out)
    return dict(out, **pretrained)


def run_train_vc2_lora(A, pretrained: dict) -> dict:
    """VideoCrafter2 LoRA (rank 16 on the kernels ``vc2_t2v_lora.yaml``'s
    targets match: attn1, attn2, and by substring the time and fps
    embeddings' fc1, fc2) through the registry's
    ``train-videocrafter-lora``, from ``flow.pretrained`` = the full
    fine-tune's ``save_pretrained`` step dir, 3 steps at 16×320×512."""
    def loaded(trainer):
        got = _fingerprint(trainer.flow.denoiser)
        same = got == pretrained["fingerprint"]
        log("train-vc2-lora", from_pretrained=pretrained["dir"],
            unet_matches_saved=same)
        if not same:
            raise AssertionError("train-vc2-lora: the UNet is not the one "
                                 "save_pretrained wrote")

    _free()
    log("train-vc2-lora", command=VC2_LORA_COMMAND,
        frames=VC2_TRAIN_FRAMES, height=VC2_TRAIN_SIZE[0],
        width=VC2_TRAIN_SIZE[1], batch=1, lora_rank=16,
        pretrained=pretrained["dir"])
    out = _train_run(A, "train-vc2-lora", _vc2_train_argv(
        VC2_LORA_COMMAND, "train_vc2_lora",
        [f"flow.pretrained={pretrained['dir']}"]), VC2_TRAIN_PER_STEP,
        lora=True, resume=False, on_built=loaded)
    _check_vc2_sm90("train-vc2-lora", out)
    return out


def _narrow_vc_train():
    """VideoCrafter2 at narrow width for one training step, 64-wide heads
    and bf16 kept (the Hopper kernels' dtype; the port's backward takes
    bf16 only on the card): the UNet at model_channels 64, one res block a
    level, two levels ([1, 2], attention at both), a 2-layer CLIP of dim
    64, the VAE at ch 32."""
    u = "flow.params.denoiser_config.params"
    c = "flow.params.cond_stage_config.params"
    return [f"{u}.model_channels=64", f"{u}.num_res_blocks=1",
            f"{u}.channel_mult=[1, 2]", f"{u}.attention_resolutions=[1, 2]",
            f"{u}.context_dim=64", f"{c}.dim=64", f"{c}.heads=2",
            f"{c}.num_layers=2", "flow.params.first_stage_config.params.ch=32",
            "flow.params.first_stage_config.params.num_res_blocks=1"]


@tf32_off()
def check_train_reference_vc(A, control: float = 0.0) -> None:
    """One VideoCrafter2 full fine-tune step at narrow width
    (``_narrow_vc_train``), TF32 off: the card's bf16 UNet against the same
    weights as an f32 UNet on the CPU (the reference), with the same
    latents, text states, fps, t and noise.  2×16×32 latents give 512
    tokens at level 1 (1 head: K5 and K8, self and over 77 keys) and 128 at
    level 2 and in the middle (2 heads: K1 and K7 self, K5 and K7 over 77
    keys), each on a Hopper design at d=64 on the card.  The loss within
    ``TRAIN_LOSS_TOL`` and every UNet gradient within ``TRAIN_GRAD_TOL``
    of the f32 reference, as ``check_train_reference`` holds its flows,
    or within twice the CPU's own bf16 UNet's error on that gradient where
    that is larger: bf16 rounding alone moves the convolutions' gradients
    by about 3e-2 of their max (the CPU's bf16 UNet against the reference,
    and the card against the CPU, read 3.0e-2 to 3.3e-2 on the H100,
    PERF.md).  The bf16 model stays on the card because there is no f32
    backward kernel (``flash_bwd`` takes bf16 on CUDA).  With ``control``
    > 0 every card attention output is scaled by 1 + ``control`` and the
    check must fail."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    diff = A.flash_attention_diff

    def scaled(*args, **kwargs):
        out = diff(*args, **kwargs)
        return out * (1 + control) if out.is_cuda else out

    narrow = _narrow_vc_train()
    cfg = load_configs([CONFIG_VC2], narrow)
    cpu = instantiate(cfg["flow"], device="cpu")
    cpu.init_params(seed=1)
    ref = instantiate(load_configs([CONFIG_VC2], narrow + [
        "flow.params.denoiser_config.params.dtype=float32"])["flow"],
        device="cpu")
    ref.denoiser.load_state_dict({k: v.float() for k, v in
                                  cpu.denoiser.state_dict().items()})
    gpu = instantiate(cfg["flow"], device="cuda")
    gpu.denoiser.load_state_dict(cpu.denoiser.state_dict())
    gen = torch.Generator().manual_seed(2)
    batch = {"latents": torch.randn((1, 2, 16, 32, 4), generator=gen),
             "text_states": torch.randn((1, 77, 64), generator=gen),
             "fps": torch.tensor([28.0])}
    draw = {"t": torch.tensor([417]),
            "noise": torch.randn((1, 2, 16, 32, 4), generator=gen),
            "drop": torch.tensor([False])}
    losses, grads = [], []
    if control:
        A.flash_attention_diff = scaled
    try:
        for flow, dev in ((ref, "cpu"), (cpu, "cpu"), (gpu, "cuda")):
            flow.denoiser.requires_grad_(True)
            zero_counts(A)
            loss, _ = flow.training_loss(
                {k: v.to(dev) for k, v in batch.items()},
                **{k: v.to(dev) for k, v in draw.items()})
            loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in read_counts(A).items() if v}
                hopper = {k: v for k, v in read_sm90_counts(A).items()
                          if v and k.startswith("K")}
            losses.append(loss.item())
            grads.append({n: p.grad.float().cpu() for n, p in
                          flow.denoiser.named_parameters()
                          if p.grad is not None})
    finally:
        A.flash_attention_diff = diff
    # level 1's 3 spatial transformers (1 down, 2 up), 4 at level 2 (1
    # down, 2 up, the middle); every backward over one key tile on
    # flash_bwd_rows_sm90: level 1's cross-attentions (77 keys) and all of
    # level 2's (77 and 128 keys)
    expect = {"K5": 10, "K1": 4, "K8": 6, "K7": 8}
    expect_hopper = dict(expect, K8_rows=3, K7_rows=8)

    def calibrated(named_card, named_cpu, named_ref):
        """Each gradient's error against the f32 reference within
        TRAIN_GRAD_TOL of its own max|g| plus TRAIN_GRAD_TOL/100 of the
        largest, or within twice the CPU's own bf16 error on it, whichever
        is larger; (worst err/tol, its name, how many took the second)."""
        gmax = max(g.abs().max().item() for g in named_ref.values())
        worst, name, calib = 0.0, "", 0
        for n, ref_g in named_ref.items():
            err = (named_card[n].float() - ref_g).abs().max().item()
            cpu_err = (named_cpu[n].float() - ref_g).abs().max().item()
            fixed = TRAIN_GRAD_TOL * (ref_g.abs().max().item() + gmax / 100)
            tol = max(fixed, 2 * cpu_err)
            calib += tol > fixed
            ratio = err / tol if math.isfinite(err) else float("inf")
            if ratio > worst:
                worst, name = ratio, n
        return worst, name, calib

    rel = abs(losses[2] - losses[0]) / abs(losses[0])
    cpu_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    worst, worst_name, calib = calibrated(grads[2], grads[1], grads[0])
    ok = (math.isfinite(rel) and rel <= TRAIN_LOSS_TOL and worst <= 1.0
          and launches == expect and hopper == expect_hopper
          and set(grads[0]) == set(grads[1]) == set(grads[2]))
    log("train-reference-vc", flow="narrow vc2_t2v_320x512, one full "
        "fine-tune step, card bf16 vs cpu f32", control=control,
        loss_ref=f"{losses[0]:.6f}", loss_card=f"{losses[2]:.6f}",
        loss_rel_err=f"{rel:.3e}", loss_tol=TRAIN_LOSS_TOL,
        cpu_bf16_loss_rel_err=f"{cpu_rel:.3e}", grads=len(grads[0]),
        worst_grad_err_over_tol=f"{worst:.3f}", worst_grad=worst_name,
        grad_tol=f"max({TRAIN_GRAD_TOL}*(own+max/100),2*cpu_bf16_err)",
        grads_on_cpu_bf16_tol=calib, card_launches=launches,
        hopper_launches=hopper, tf32=tf32_flags(), ok=ok)
    if control and ok:
        raise AssertionError(f"train-reference-vc passed with every card "
                             f"attention output scaled by 1 + {control}")
    if not control and not ok:
        raise AssertionError("train-reference-vc: card and CPU disagree")
    del cpu, gpu, ref
    _free()


# ------------------------------------------------------ StepVideo and Mochi
CONFIG_STEP = os.path.join(ROOT, "configs", "009_stepvideo",
                           "stepvideo_t2v.yaml")
CONFIG_MOCHI = os.path.join(ROOT, "configs", "010_mochi", "mochi_t2v.yaml")
STEP_COMMAND = "inference-stepvideo-t2v-544x992"
MOCHI_COMMAND = "inference-mochi"
STEP_PROMPT = "a koi pond at dusk, ripples spreading under lanterns"
MOCHI_PROMPT = "a paper boat drifting down a rain gutter after a storm"
# StepVideo at 51×544×992: 6×34×62 latents, 12,648 tokens at patch
# (1, 1, 1); 48 heads of d = 128; its cross-attention's keys are the CLIP's
# 77 tokens (always valid) before the 320 caption tokens.  B=2 under CFG
STEP_TOKENS = 6 * 34 * 62
STEP_CLIP, STEP_CAPTION = 77, 320
STEP_HEADS = 48
STEP_STEPS = 2               # of the config's 50: every step costs the same
STEP_DEPTH = 48              # DiT layers: a self- and a cross-attention each
# StepLLM in the config's f32 at 4 of its 48 layers (1.56 GB a layer), so
# that the 58 GB bf16 DiT at full depth, the CLIP and the VAE fit beside it
STEP_LLM_LAYERS = 4
# Mochi at 84×480×848: 14×60×106 latents, 14×30×53 = 22,260 video tokens
# after the 2×2 patch, + 256 caption keys; 24 heads of d = 128.  B=2
MOCHI_VIDEO, MOCHI_TEXT = 14 * 30 * 53, 256
MOCHI_HEADS = 24
MOCHI_STEPS = 2              # of the config's 64
MOCHI_DEPTH = 48
# latent frames decoded (of 14): 19 pixel frames at 480×848, as many as
# leave the f32 decode room beside the DiT's and the T5's weights
MOCHI_DECODE_LATENT_FRAMES = 4
# K-step's key masks: (name, valid keys after the always-valid lead, row 0
# and row 1): all valid, a caption prefix in both rows, rows padded apart
STEP_MASKS = (("all_valid", None, None), ("caption_prefix", 30, 30),
              ("ragged_rows", 120, 9))
MOCHI_MASKS = (("all_valid", None, None), ("caption_prefix", 40, 40),
               ("ragged_rows", 200, 5))


def _lead_mask(b, lead, caption, rows):
    """(B, lead + caption) bool: the lead keys valid, then row i's first
    rows[i] caption keys (all where None)."""
    m = torch.zeros((b, lead + caption), dtype=torch.bool, device="cuda")
    m[:, :lead] = True
    for i, n in enumerate(rows):
        m[i, lead:lead + (caption if n is None else n)] = True
    return m


def _plain_masked_chunked(A, q, k, v, kv_valid, static_max, rows=256):
    """The plain version over all query rows, a block of rows at a time."""
    return torch.cat([A.flash_fwd_plain(
        q[:, i:i + rows], k, v, sm_scale=q.shape[-1] ** -0.5,
        kv_valid=kv_valid, static_max=static_max)
        for i in range(0, q.shape[1], rows)], dim=1)


def _step_case(A, label, q, k, v, masks, lead, caption, static_max, rec,
               phase="K-step", device=False):
    """K2 (no mask) or K4 (each of ``masks``) at d = 128 through
    ``flash_attention`` against its plain version, counted on the route, on
    flash_fwd_sm90 and at d = 128 once a call; then timed on the last
    mask's tensors beside flash_fwd.cu (in turns: new, old, old, new), the
    plain version, SDPA (with the boolean mask where there is one) and the
    bound of the keys that the mask keeps; with ``device`` also by device
    time (CUDA-graph replay), in the same turns, SDPA's too."""
    route = "K2" if masks is None else "K4"
    b, sq, h, d = q.shape
    kw = {} if static_max is None else {"static_max": static_max}
    mask = None
    for name, r0, r1 in masks or (("no_mask", None, None),):
        mask = None if masks is None else _lead_mask(b, lead, caption,
                                                     (r0, r1))
        counts = lambda: (A.flash_fwd.launches[route],
                          A.flash_fwd.launches_sm90[route],
                          A.flash_fwd.launches_d128[route])
        before = counts()
        out = A.flash_attention(q, k, v, kv_valid=mask, **kw)
        torch.cuda.synchronize()
        launched = counts()
        t0 = time.perf_counter()
        ref = _plain_masked_chunked(A, q, k, v, mask, static_max)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = (err <= FWD_TOL * scale and bool(torch.isfinite(out).all())
              and launched == tuple(n + 1 for n in before))
        log(phase, case=f"{label} {name}",
            shape=f"B{b}xSq{sq}xSk{k.shape[1]}xH{h}xd{d}", route=route,
            kernel="flash_fwd_sm90 (K3's kernel, d=128)",
            softmax="online" if static_max is None else f"fixed {static_max}",
            valid_keys=(None if mask is None
                        else mask.sum(1).tolist()),
            key_tail=k.shape[1] % 128, max_abs_err=f"{err:.3e}",
            tol=f"{FWD_TOL * scale:.3e}", plain_ms=f"{plain_ms:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"{route} at d=128 disagrees with its plain "
                                 f"version ({label}, {name}) or did not "
                                 "launch K3's kernel")
        rec.setdefault("max_abs_err", 0.0)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del out, ref
    valid = (torch.full((b,), k.shape[1], device="cuda") if mask is None
             else mask.sum(1)).sum().item()
    flops = 4.0 * h * sq * valid * d
    io_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = _bound(flops, io_bytes,
                                _exp2_floor_ms(h * sq * valid))
    new = lambda: A.flash_attention(q, k, v, kv_valid=mask, **kw)
    old = lambda: A._flash_fwd_mma(q, k, v, d ** -0.5, False, mask,
                                   static_max, False)
    t = [cuda_time_ms(fn, reps=10) for fn in (new, old, old, new)]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_kw = {} if mask is None else {"attn_mask": mask[:, None, None, :]}
    library_ms, backend = sdpa_ms((qt, kt, vt), lib_kw, reps=10)
    del qt, kt, vt
    rec.update(ms=min(t[0], t[3]), old_design_ms=min(t[1], t[2]),
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms)
    if device:
        from videotuna_tpu_torch.kernels.attribution import device_ms
        dev = [device_ms(fn, reps=5) for fn in (new, old, old, new)]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rec.update(device_ms=min(dev[0], dev[3]),
                   old_design_device_ms=min(dev[1], dev[2]),
                   library_device_ms=sdpa_device_ms((qt, kt, vt), lib_kw,
                                                    reps=5)[0])
        del qt, kt, vt
        log(phase, case=f"{label} device time",
            device_ms=f"{rec['device_ms']:.3f}",
            turns="/".join(f"{x:.3f}" for x in dev),
            old_design_device_ms=f"{rec['old_design_device_ms']:.3f}",
            library_device_ms=f"{rec['library_device_ms']:.3f}")
    log(phase, case=f"{label} timing", ms=f"{rec['ms']:.3f}",
        turns="/".join(f"{x:.3f}" for x in t),
        old_design="flash_fwd.cu", old_design_ms=f"{rec['old_design_ms']:.3f}",
        vs_old_design=f"{rec['old_design_ms'] / rec['ms']:.3f}",
        bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        tflops=f"{flops / rec['ms'] / 1e9:.1f}",
        of_bound=f"{bound_ms / rec['ms']:.3f}", plain_ms=f"{plain_ms:.1f}",
        library=f"scaled_dot_product_attention[{backend}]"
                + ("(attn_mask)" if mask is not None else ""),
        library_ms=f"{library_ms:.3f}",
        vs_library=f"{library_ms / rec['ms']:.3f}")
    return rec


def check_k_step(A) -> dict:
    """The d = 128 kernels of StepVideo and Mochi at their sampling shapes
    (B=2 under CFG), bf16, each against its plain version and timed beside
    flash_fwd.cu, SDPA and its bound: StepVideo's self-attention (K2,
    online: 12,648², H=48), its cross-attention (K4, online, 12,648 queries
    over 77 CLIP + 320 caption keys, H=48) and Mochi's joint attention (K4
    under the fixed max 0, 22,516² with the caption padding masked, H=24),
    each key mask in three patterns; and StepLLM's f32 causal K2 at 320
    tokens (48 heads over 8 repeated key/value groups) on the f32 design."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    gen = torch.Generator(device="cuda").manual_seed(16)
    recs = {}
    s, h = STEP_TOKENS, STEP_HEADS
    q, k, v = (_rand((2, n, h, 128), gen, normed=True)
               for n in (s, s, s))
    recs["step self"] = _step_case(A, "stepvideo self", q, k, v, None, 0, 0,
                                   None, {})
    del k, v
    _free()
    k, v = (_rand((2, STEP_CLIP + STEP_CAPTION, h, 128), gen, normed=True)
            for _ in range(2))
    recs["step cross"] = _step_case(A, "stepvideo cross", q, k, v,
                                    STEP_MASKS, STEP_CLIP, STEP_CAPTION,
                                    None, {})
    del q, k, v
    _free()
    n = MOCHI_VIDEO + MOCHI_TEXT
    q, k, v = (_rand((2, n, MOCHI_HEADS, 128), gen, normed=True)
               for _ in range(3))
    recs["mochi joint"] = _step_case(A, "mochi joint", q, k, v, MOCHI_MASKS,
                                     MOCHI_VIDEO, MOCHI_TEXT, 0.0, {})
    del q, k, v
    _free()
    # StepLLM: f32, causal, 320 tokens, 48 heads of d = 128
    s, h = STEP_CAPTION, STEP_HEADS
    q, k, v = (torch.randn((1, s, h, 128), generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(sm_scale=128 ** -0.5, causal=True)
    before = (A.flash_fwd.launches_f32["K2"], A.flash_fwd.launches_sm90["K2"])
    out = A.flash_fwd(q, k, v, **kw)
    ref = A.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = F32_TOL * ref.abs().max().item()
    ok = err <= tol and (A.flash_fwd.launches_f32["K2"],
                         A.flash_fwd.launches_sm90["K2"]) == (
        before[0] + 1, before[1])
    new = lambda: A.flash_fwd(q, k, v, **kw)
    old = lambda: A._flash_fwd_mma(q, k, v, kw["sm_scale"], True, None, None,
                                   False)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, backend = sdpa_ms((qt, kt, vt), {"is_causal": True}, reps=50)
    bound_ms, bound_by = _bound(3 * 4.0 * h * 128 * s * (s + 1) / 2,
                                4 * q.numel() * q.element_size())
    dev = [device_ms(fn, reps=50) for fn in (new, old, old, new)]
    rec = dict(max_abs_err=err, ms=cuda_time_ms(new, reps=50),
               device_ms=min(dev[0], dev[3]),
               old_design_ms=cuda_time_ms(old, reps=50),
               old_design_device_ms=min(dev[1], dev[2]),
               plain_ms=cuda_time_ms(lambda: A.flash_fwd_plain(q, k, v, **kw),
                                     reps=5),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    log("K-step", case="stepllm f32 causal", shape=f"B1xS{s}xH{h}xd128",
        kernel="flash_fwd_f32_sm90",
        splits=A._fwd_plan("f32", q, k, True, False).splits,
        max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
        **{k_: (f"{v_:.4f}" if isinstance(v_, float) else v_)
           for k_, v_ in rec.items() if k_ != "max_abs_err"},
        library=f"scaled_dot_product_attention[{backend}](is_causal)", ok=ok)
    if not ok:
        raise AssertionError("StepLLM's f32 causal K2 disagrees with its "
                             "plain version or left the f32 design")
    recs["stepllm"] = rec
    return recs


def _check_narrow_dit(A, phase, make, inputs, static_max, expected):
    """A narrow DiT in bf16 on the card against the same weights in f32 on
    the CPU, one call on the same inputs (TF32 off): the launches on the
    card (``expected``, every one on flash_fwd_sm90 at d = 128) and the
    relative error within REF_TOL_CALL."""
    from videotuna_tpu_torch.models.layers import init_weights_
    cpu = make(torch.float32)
    init_weights_(cpu, torch.Generator().manual_seed(1))
    gpu = make(torch.bfloat16).cuda()
    gpu.load_state_dict(cpu.state_dict())
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        zero_counts(A)
        with torch.inference_mode(), A.attention_options(
                static_max=static_max):
            outs.append(model(*[None if x is None else x.to(dev)
                                for x in inputs]).float().cpu())
        launches = {k: n for k, n in read_counts(A).items() if n}
    sm90 = read_sm90_counts(A)
    err = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    ok = (math.isfinite(err) and err <= REF_TOL_CALL
          and launches == expected
          and all(sm90[k] == sm90[f"{k}_d128"] == n
                  for k, n in expected.items()))
    log(phase, what="narrow DiT, bf16 on the card vs f32 on the cpu",
        card_launches=launches, rel_err=f"{err:.3e}", tol=REF_TOL_CALL,
        ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: the card's narrow DiT disagrees with "
                             f"the CPU's or launched {launches}")
    del cpu, gpu
    _free()


@tf32_off()
def check_small_reference_stepvideo(A) -> None:
    """StepVideo's DiT at dim 256 (2 heads of d = 128), 2 layers, on 2×8×16
    latents (256 tokens, B=2), the CLIP's 77 states before 20 caption
    tokens with row 1 keeping 7: two self-attentions (K2, online) and two
    cross-attentions (K4, online, the key mask) on the card."""
    from videotuna_tpu_torch.models.stepvideo.dit import StepVideoModel
    gen = torch.Generator().manual_seed(2)
    mask = torch.ones((2, 20), dtype=torch.bool)
    mask[1, 7:] = False
    inputs = [torch.randn((2, 2, 8, 16, 64), generator=gen),
              torch.tensor([999.0, 500.0]),
              torch.randn((2, 20, 64), generator=gen),
              torch.randn((2, 77, 32), generator=gen), mask]
    _check_narrow_dit(
        A, "reference-step", lambda dt: StepVideoModel(
            dim=256, ffn_dim=512, num_layers=2, heads=2, text_dim=64,
            clip_dim=32, dtype=dt), inputs, None, {"K2": 2, "K4": 2})


@tf32_off()
def check_small_reference_mochi(A) -> None:
    """Mochi's DiT at dim 256 / 64 (2 heads of d = 128), 3 blocks, on
    2×16×16 latents (128 video tokens, B=2) and 16 caption tokens with
    row 1 keeping 5: three joint attentions (K4 under the fixed max 0)."""
    from videotuna_tpu_torch.models.mochi.dit import MochiDiT
    gen = torch.Generator().manual_seed(3)
    mask = torch.ones((2, 16), dtype=torch.bool)
    mask[1, 5:] = False
    inputs = [torch.randn((2, 2, 16, 16, 12), generator=gen),
              torch.tensor([999.0, 500.0]),
              torch.randn((2, 16, 64), generator=gen), mask]
    _check_narrow_dit(
        A, "reference-mochi", lambda dt: MochiDiT(
            dim=256, dim_y=64, depth=3, heads=2, caption_channels=64,
            dtype=dt), inputs, 0.0, {"K4": 3})


def _run_command(A, phase, argv, tag):
    """``argv`` through the registry with every count zeroed before and
    read after; returns (launches, Hopper launches, metric.json, the
    video, seconds, peak bytes)."""
    from videotuna_tpu_torch.cli.commands import main as command
    savedir = os.path.join(OUT_DIR, tag)
    _free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    t0 = time.perf_counter()
    rc = command([*argv[:1], "--device", "cuda", "--quiet", "--savedir",
                  savedir, *argv[1:]])
    wall = time.perf_counter() - t0
    launches, sm90 = read_counts(A), read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(savedir, "metric.json")) as f:
        m = json.load(f)
    videos = sorted(p for p in os.listdir(savedir)
                    if p.endswith((".mp4", ".npy")))
    video = _read_video(os.path.join(savedir, videos[0]))
    if rc != 0 or len(videos) != 1 or m["nonfinite_latents"] \
            or m["nonfinite_pixels"]:
        raise AssertionError(f"{phase}: rc {rc}, videos {videos}, "
                             f"non-finite {m['nonfinite_latents']}, "
                             f"{m['nonfinite_pixels']}")
    return launches, sm90, m, video, wall, peak


def run_e2e_stepvideo(A) -> dict:
    """StepVideo T2V 30B through the registry's
    ``inference-stepvideo-t2v-544x992`` (configs/009_stepvideo) on one card:
    the one-device mesh (``inference.mesh.tp=1``), the DiT at full width
    and depth (dim 6144, 48 layers, 48 heads of d = 128, bf16), the CLIP-L
    and the VAE as configured, random weights from the seed, one prompt at
    51×544×992 (6×34×62 latents, 12,648 tokens) with CFG 9.  Cuts: 2 of the
    50 Euler steps; StepLLM (f32, dim 6144) at ``STEP_LLM_LAYERS`` of 48
    layers.  Every self-attention launches K2 and every cross-attention K4
    on K3's Hopper kernel at d = 128 (online max; the caption mask), every
    StepLLM attention the f32 design; no other launch."""
    cuts = ["inference.mesh.tp=1",
            f"flow.params.scheduler_config.params.num_steps={STEP_STEPS}",
            f"flow.params.cond_stage_config.params.num_layers="
            f"{STEP_LLM_LAYERS}"]
    launches, sm90, m, video, wall, peak = _run_command(
        A, "e2e-stepvideo", [STEP_COMMAND, "--prompt", STEP_PROMPT, *cuts],
        "e2e_stepvideo")
    per = STEP_DEPTH * STEP_STEPS
    llm = 2 * STEP_LLM_LAYERS        # the prompt's and the negative's
    log("e2e-stepvideo", command=STEP_COMMAND, cuts=" ".join(cuts),
        frames=51, height=544, width=992, tokens=STEP_TOKENS,
        cross_keys=STEP_CLIP + STEP_CAPTION, batch="2 (CFG)",
        steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", run_sec=f"{wall:.1f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", latent_shape=m["latent_shape"],
        launches=launches, sm90_launches=sm90,
        video_shape="x".join(map(str, video.shape)))
    expected = dict({k: 0 for k in launches}, K2=per + llm, K4=per)
    if m["denoise_steps"] != STEP_STEPS or launches != expected \
            or (sm90["K2"], sm90["K2_d128"], sm90["K4"], sm90["K4_d128"],
                sm90["K2_f32"], sm90["tma_copies"]) != (per, per, per, per,
                                                        llm, 0) \
            or sum(n for k, n in sm90.items() if k.endswith("_split")) \
            > llm:
        raise AssertionError(f"e2e-stepvideo: launches {launches}, {sm90}: "
                             f"expected K2 {per} and K4 {per} on K3's "
                             f"kernel at d=128, {llm} StepLLM K2 on the f32 "
                             "design, no other, no copy")
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                sec_per_step=m["sample_sec"] / m["denoise_steps"],
                text_encode_sec=m["encode_sec"], decode_sec=m["decode_sec"])


def run_dit_stepvideo_48(A) -> dict:
    """StepVideo's DiT alone at full width and depth (48 layers, bf16, 58 GB
    of weights made on the card from the seed): one denoiser call with CFG
    (B=2, 12,648 tokens, StepLLM-shaped states over 320 tokens with a
    caption of 12 valid, the CLIP's 77), the work of one sampling step,
    after one warm-up call; CUDA-event time and peak memory."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    _free()
    cfg = load_configs([CONFIG_STEP])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    weights = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((2, 6, 34, 62, 64), generator=gen, device="cuda")
    y = torch.randn((2, STEP_CAPTION, 6144), generator=gen, device="cuda")
    y2 = torch.randn((2, STEP_CLIP, 1024), generator=gen, device="cuda")
    mask = _lead_mask(2, 0, STEP_CAPTION, (12, 12))
    t = torch.tensor([999.0, 999.0], device="cuda")
    with torch.inference_mode():
        model(x, t, y, y2, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(A)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = model(x, t, y, y2, mask)
        end.record()
        torch.cuda.synchronize()
    launches, sm90 = read_counts(A), read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    step_sec = start.elapsed_time(end) / 1e3
    ok = (bool(torch.isfinite(out).all())
          and launches == dict({k: 0 for k in launches}, K2=STEP_DEPTH,
                               K4=STEP_DEPTH)
          and sm90["K2_d128"] == sm90["K4_d128"] == STEP_DEPTH)
    log("dit-stepvideo-48", layers=STEP_DEPTH, dim=6144, heads=STEP_HEADS,
        tokens=STEP_TOKENS, batch="2 (CFG)", weights_gb=f"{weights / 1e9:.2f}",
        step_sec=f"{step_sec:.3f}", peak_mem_gb=f"{peak / 1e9:.2f}",
        launches=launches, ok=ok)
    if not ok:
        raise AssertionError("dit-stepvideo-48: non-finite output or "
                             f"launches {launches}")
    del model, out
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                step_sec=step_sec, weights_gb=weights / 1e9)


def run_e2e_mochi(A) -> dict:
    """Mochi-1 T2V through the registry's ``inference-mochi``
    (configs/010_mochi) at full width and depth (the AsymmDiT: dim 3072 /
    1536, 48 blocks, 24 heads of d = 128, bf16; T5-XXL in f32 over 256
    tokens; the Mochi VAE in f32), random weights from the seed, one prompt
    at 84×480×848 (14×60×106 latents, 22,260 video tokens + 256 caption
    keys) with CFG 4.5.  Cuts: 2 of the 64 Euler steps; the first
    ``MOCHI_DECODE_LATENT_FRAMES`` latent frames decoded.  Every joint
    attention launches K4 on K3's Hopper kernel at d = 128 (the fixed max
    0, the caption mask); no other launch."""
    cuts = [f"flow.params.scheduler_config.params.num_steps={MOCHI_STEPS}",
            f"inference.decode_latent_frames={MOCHI_DECODE_LATENT_FRAMES}"]
    launches, sm90, m, video, wall, peak = _run_command(
        A, "e2e-mochi", [MOCHI_COMMAND, "--prompt", MOCHI_PROMPT, *cuts],
        "e2e_mochi")
    per = MOCHI_DEPTH * MOCHI_STEPS
    frames = (MOCHI_DECODE_LATENT_FRAMES - 1) * 6 + 1
    log("e2e-mochi", command=MOCHI_COMMAND, cuts=" ".join(cuts), frames=84,
        height=480, width=848, tokens=MOCHI_VIDEO + MOCHI_TEXT,
        batch="2 (CFG)", steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", run_sec=f"{wall:.1f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", latent_shape=m["latent_shape"],
        decoded_latent_shape=m["decoded_latent_shape"], launches=launches,
        sm90_launches=sm90, video_shape="x".join(map(str, video.shape)))
    if m["denoise_steps"] != MOCHI_STEPS \
            or launches != dict({k: 0 for k in launches}, K4=per) \
            or (sm90["K4"], sm90["K4_d128"], sm90["tma_copies"]) \
            != (per, per, 0) \
            or tuple(video.shape) != (frames, 480, 848, 3):
        raise AssertionError(f"e2e-mochi: launches {launches}, {sm90}, "
                             f"video {video.shape}: expected K4 {per} on "
                             "K3's kernel at d=128 and no other")
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                sec_per_step=m["sample_sec"] / m["denoise_steps"],
                text_encode_sec=m["encode_sec"], decode_sec=m["decode_sec"],
                decoded_frames=frames)


def run_stepvideo_mochi(A) -> tuple:
    """The StepVideo and Mochi phases in order: (K-step's records, the
    e2e runs, the 48-layer DiT step)."""
    kstep = timed_phase("K-step", check_k_step, A)
    check_small_reference_stepvideo(A)
    check_small_reference_mochi(A)
    step = timed_phase("e2e-stepvideo", run_e2e_stepvideo, A)
    dit48 = timed_phase("dit-stepvideo-48", run_dit_stepvideo_48, A)
    mochi = timed_phase("e2e-mochi", run_e2e_mochi, A)
    return kstep, [step, mochi], dit48


# ---------------------------------------------------------------- phases 51-57
CONFIG_FLUX_DEV = os.path.join(ROOT, "configs", "006_flux", "flux_dev.yaml")
CONFIG_FLUX_LORA = os.path.join(ROOT, "configs", "006_flux",
                                "flux_lora.yaml")
CONFIG_V2V_UNET = os.path.join(ROOT, "configs", "011_v2v",
                               "v2v_enhance_unet.yaml")
FLUX_DEV_COMMAND = "inference-flux-dev"
FLUX_SCHNELL_COMMAND = "inference-flux-schnell"
V2V_COMMAND = "inference-v2v-ms"
FLUX_PROMPT = "a photo of a forest with mist swirling around the tree trunks"
V2V_PROMPT = "a koi pond with lily pads, sharp and detailed"
# Flux at 768×1360: 48×85 packed latents, 4,080 image + 512 T5 tokens in
# each joint attention; 24 heads of d = 128; one K2 a block: 19 double +
# 38 single
FLUX_SIZE = (768, 1360)
FLUX_TOKENS = (768 // 16) * (1360 // 16) + 512
FLUX_HEADS = 24
FLUX_DEPTH = 19 + 38
FLUX_DEV_STEPS = 28          # the config's every step
FLUX_SCHNELL_STEPS = 4
# Flux LoRA training at 768×768: 48×48 packed latents, 2,304 + 512 tokens
FLUX_TRAIN_SIZE = (768, 768)
FLUX_TRAIN_TOKENS = (768 // 16) ** 2 + 512
# inference-v2v-ms: VideoCrafter2 at 16×320×512, DDIM from strength 0.4 of
# its 50 steps (20), CFG 7.5; the enhancement model's every step (50)
V2V_FRAMES, V2V_SIZE = 16, (320, 512)
V2V_SDEDIT_STEPS = 20
V2V_ENHANCE_STEPS = 50


def check_k_flux(A) -> dict:
    """Flux's d = 128 kernels at its shapes, bf16, each against its plain
    version and timed by CUDA events and device time beside flash_fwd.cu
    (or flash_bwd.cu), SDPA and its bound: K2 online at sampling's 4,592
    tokens (B=1, H=24: dev and schnell at 768×1360) on K3's kernel; K5
    online with the LSE and K8 unmasked at LoRA training's 2,816 tokens
    (768×768) on K3's kernel and flash_bwd_sm90."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (_rand((1, FLUX_TOKENS, FLUX_HEADS, 128), gen, normed=True)
               for _ in range(3))
    k2 = _step_case(A, "flux sampling joint", q, k, v, None, 0, 0, None, {},
                    phase="K-flux", device=True)
    del q, k, v
    _free()
    k5, k8 = _train_attention(A, gen, FLUX_TRAIN_TOKENS, None, "flux",
                              phase="K-flux", device=True)
    _free()
    return {"K2": k2, "K5": k5, "K8": k8}


def _narrow_flux():
    """Flux at narrow width, d = 128 kept: the DiT at dim 256 (2 heads, 1
    double and 2 single blocks, bf16 as configured), a one-layer T5 of dim
    64, a 2-layer CLIP of dim 64, the VAE at ch 32, 32 T5 tokens, 2
    steps."""
    d = "flow.params.denoiser_config.params"
    t5 = "flow.params.cond_stage_config.params"
    clip = "flow.params.cond_stage_2_config.params"
    vae = "flow.params.first_stage_config.params"
    return [f"{d}.dim=256", f"{d}.heads=2", f"{d}.double_blocks=1",
            f"{d}.single_blocks=2", f"{d}.text_dim=64", f"{d}.pooled_dim=64",
            f"{d}.scan_blocks=false", f"{t5}.dim=64", f"{t5}.heads=2",
            f"{t5}.head_dim=32", f"{t5}.ff_dim=128", f"{t5}.num_layers=1",
            f"{clip}.dim=64", f"{clip}.heads=2", f"{clip}.num_layers=2",
            f"{vae}.ch=32", f"{vae}.num_res_blocks=1",
            "flow.params.model_max_length=32",
            "flow.params.num_inference_steps=2"]


def _draw_final_proj(flow, seed: int) -> None:
    """Flux's final_proj is zero-initialised (flax's zeros): a card-vs-CPU
    check draws it, so that the DiT's output and gradients depend on every
    block."""
    with torch.no_grad():
        flow.denoiser.final_proj.weight.normal_(
            0.0, 0.05, generator=torch.Generator().manual_seed(seed))


@tf32_off()
def check_small_reference_flux(A) -> None:
    """The narrow Flux-dev flow (``_narrow_flux``) on the card and on the
    CPU with the same weights, prompt and x_T, TF32 off: 8×16 packed
    latents (a 128×256 image) give 128 image + 32 text tokens in each
    joint attention (3 a call).  Twice: with the DiT in bf16 as configured
    (K2 online on K3's Hopper kernel at d = 128; tolerances of the bf16
    checks) and in f32 (K2 on the f32 design; the f32 tolerances).  One DiT
    call, the latents after 2 steps and the decode of the same latents must
    agree; then a narrow bf16 LoRA step (``check_train_reference``'s
    flux_d128 case: K5 online and K8)."""
    for dtype in ("bfloat16", "float32"):
        _reference_flux(A, dtype)
    check_train_reference(A, only=("flux_d128",))


def _reference_flux(A, dtype: str) -> None:
    from videotuna_tpu_torch.core.config import load_configs
    cfg = load_configs([CONFIG_FLUX_DEV], _narrow_flux() + [
        f"flow.params.denoiser_config.params.dtype={dtype}"])
    n = 3 * (1 + 2)   # 3 joint attentions a call: one call and 2 steps
    design = "K2_d128" if dtype == "bfloat16" else "K2_f32"
    _flow_card_vs_cpu(
        A, f"reference-flux {dtype}", cfg, (1, 128, 256),
        lambda flow: torch.tensor([0.7]), FLUX_PROMPT, {"K2": n},
        {design: n},
        (REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE) if dtype == "bfloat16"
        else (REF_VC_TOL_CALL, REF_VC_TOL_TRAJ, REF_TOL_DECODE),
        prepare=lambda flow: _draw_final_proj(flow, 4))


def run_e2e_flux(A, name: str, steps: int) -> dict:
    """Flux T2I through the registry's ``name`` (configs/006_flux) at full
    width and depth (dim 3072, 19 double and 38 single blocks, 24 heads of
    d = 128, bf16; T5-XXL (f32, 512 tokens), CLIP-L, the 2D VAE), random
    weights from the seed, one prompt at 768×1360 (48×85 packed latents,
    4,080 + 512 tokens), B=1 (no CFG), the config's every step (dev 28 with
    the embedded guidance, schnell 4).  Every joint attention launches K2
    online on K3's Hopper kernel at d = 128 (57 a step), none on
    flash_fwd.cu; no other launch."""
    tag = name.replace("inference-", "e2e-")
    launches, sm90, m, video, wall, peak = _run_command(
        A, tag, [name, "--prompt", FLUX_PROMPT], tag.replace("-", "_"))
    per = FLUX_DEPTH * m["denoise_steps"]
    h, w = FLUX_SIZE
    log(tag, command=name, height=h, width=w, tokens=FLUX_TOKENS, batch=1,
        steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.4f}",
        sample_sec=f"{m['sample_sec']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", run_sec=f"{wall:.1f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", latent_shape=m["latent_shape"],
        launches=launches, sm90_launches=sm90,
        video_shape="x".join(map(str, video.shape)))
    if m["denoise_steps"] != steps \
            or launches != dict({k: 0 for k in launches}, K2=per) \
            or (sm90["K2"], sm90["K2_d128"], sm90["tma_copies"]) \
            != (per, per, 0) \
            or tuple(video.shape) != (1, h, w, 3) \
            or m["latent_shape"] != [1, h // 16, w // 16, 64]:
        raise AssertionError(f"{tag}: {m['denoise_steps']} steps, launches "
                             f"{launches}, {sm90}, video {video.shape}: "
                             f"expected K2 {per} on K3's kernel at d=128 and "
                             "no other")
    check_split_counts(tag, sm90)
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                steps=m["denoise_steps"],
                sec_per_step=m["sample_sec"] / m["denoise_steps"],
                text_encode_sec=m["encode_sec"], decode_sec=m["decode_sec"])


def run_train_flux(A) -> dict:
    """Flux-dev LoRA (configs/006_flux/flux_lora.yaml: rank 16 on the
    DiT's matched projections) at full width and depth, 3 optimizer steps
    at 768×768 (48×48 packed latents, 2,304 + 512 tokens), batch 1, through
    the training CLI's ``Trainer``.  Its dataset (data/anno/images.csv) is
    not in the repository and no JAX dataset fills the packed latents that
    the loss reads (ROADMAP.md queue 3), so each batch carries the packed
    latents of the port's VAE encode of a seeded synthetic image and the
    caption, which the trainer encodes (T5-XXL, CLIP-L).  Per step: K5 = 57
    (each block's joint attention forward, online, with the LSE) and K8 =
    57 (its backward), on K3's kernel and flash_bwd_sm90 at d = 128; no
    other launch."""
    from videotuna_tpu_torch.flows.flux import FluxFlow
    h, w = FLUX_TRAIN_SIZE
    per_step = {"K5": FLUX_DEPTH, "K8": FLUX_DEPTH, "K1": 0, "K2": 0,
                "K3": 0, "K4": 0, "K6": 0, "K7": 0, "K9": 0, "K10": 0}
    argv = ["--config", CONFIG_FLUX_LORA, "--device", "cuda", "--quiet",
            "--max_steps", str(TRAIN_STEPS), "--workdir",
            os.path.join(OUT_DIR, "train_flux_lora"),
            _dummy_data(1, h, w), f"train.ckpt_every={TRAIN_STEPS}",
            "train.log_every=1"]
    batches = []

    def latent_batches(trainer):
        # the packed latents of a seeded image through the flow's VAE
        gen = torch.Generator(device="cuda").manual_seed(21)
        img = torch.rand((1, 1, h, w, 3), generator=gen,
                         device="cuda") * 2 - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = FluxFlow.pack_latents(trainer.flow.encode_video(img, gen))
        torch.cuda.synchronize()
        log("train-flux-lora",
            vae_encode_sec=f"{time.perf_counter() - t0:.3f}",
            packed_latents="x".join(map(str, z.shape)))
        batches.extend({"latents": z.cpu(), "caption": [FLUX_PROMPT]}
                       for _ in range(TRAIN_STEPS))
        return batches

    log("train-flux-lora", config=os.path.relpath(CONFIG_FLUX_LORA, ROOT),
        height=h, width=w, tokens_per_attention=FLUX_TRAIN_TOKENS,
        lora_rank=16, remat=False, steps=TRAIN_STEPS,
        data="packed latents of the port's VAE encode of a seeded image "
             "(queue 3: no dataset fills them)")
    out = _train_run(A, "train-flux-lora", argv, per_step, lora=True,
                     resume=False, loader_of=latent_batches)
    sm90 = out["sm90"]
    n = FLUX_DEPTH * TRAIN_STEPS
    if (sm90["K5"], sm90["K5_d128"], sm90["K8"], sm90["K8_d128"]) \
            != (n, n, n, n):
        raise AssertionError(f"train-flux-lora: {sm90}: every K5 and K8 "
                             "must run the Hopper designs at d=128 (K3's "
                             "kernel online with the LSE, flash_bwd_sm90)")
    check_split_counts("train-flux-lora", sm90)
    return out


def _v2v_inputs() -> str:
    """A directory with one seeded 16-frame 320×512 mp4 (a drifting colour
    ramp with noise, written by cv2) and its prompt sidecar."""
    import cv2
    import numpy as np
    d = os.path.join(OUT_DIR, "v2v_inputs")
    os.makedirs(d, exist_ok=True)
    h, w = V2V_SIZE
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    writer = cv2.VideoWriter(os.path.join(d, "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    for f in range(V2V_FRAMES):
        ramp = np.stack([(xx + 8 * f) % 256, (yy + 4 * f) % 256,
                         (xx + yy) % 256], -1)
        noise = rng.integers(-20, 20, (h, w, 3))
        writer.write(np.clip(ramp + noise, 0, 255).astype(np.uint8))
    writer.release()
    with open(os.path.join(d, "clip.txt"), "w") as f:
        f.write(V2V_PROMPT + "\n")
    return d


def _run_v2v(A, phase: str, argv, steps: int, run) -> dict:
    """One enhancement run of the 16-frame 320×512 clip (``run(argv)``)
    with every count zeroed before and read after: VideoCrafter2's UNet3D
    with CFG (B = 2·16) at ``steps`` steps, its K2 (level 1, 5 heads) and
    K1 on the persistent kernel at d = 64, no other launch; the enhanced
    mp4's frames."""
    savedir = os.path.join(OUT_DIR, phase.replace("-", "_"))
    _free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    t0 = time.perf_counter()
    rc = run(argv + ["--device", "cuda", "--quiet", "--input-dir",
                     _v2v_inputs(), "--output-dir", savedir])
    wall = time.perf_counter() - t0
    launches, sm90 = read_counts(A), read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    video = _read_video(os.path.join(savedir, "clip.mp4"))
    with open(os.path.join(savedir, "metric.json")) as f:
        sec = json.load(f)["per_video_sec"]["clip.mp4"]
    k2, k1 = _unet_launches(V2V_SIZE, False)
    h, w = V2V_SIZE
    log(phase, argv=" ".join(argv), frames=V2V_FRAMES, height=h, width=w,
        steps=steps, batch="2x16 (CFG)", video_sec=f"{sec:.3f}",
        sec_per_step_with_encode_decode=f"{sec / steps:.4f}",
        run_sec=f"{wall:.1f}", peak_mem_gb=f"{peak / 1e9:.2f}",
        launches=launches,
        sm90_launches=sm90, video_shape="x".join(map(str, video.shape)))
    expected = dict({k: 0 for k in launches}, K2=k2 * steps, K1=k1 * steps)
    if rc != 0 or launches != expected \
            or (sm90["K2"], sm90["K1"], sm90["tma_copies"]) \
            != (k2 * steps, k1 * steps, 0) \
            or tuple(video.shape) != (V2V_FRAMES, h, w, 3):
        raise AssertionError(f"{phase}: rc {rc}, launches {launches}, "
                             f"{sm90}, video {video.shape}: expected "
                             f"{expected} on flash_fwd_sm90")
    check_split_counts(phase, sm90)
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                steps=steps, video_sec=sec, run_sec=wall)


def run_e2e_v2v(A) -> list:
    """Video-to-video on the clip of ``_v2v_inputs``: the registry's
    ``inference-v2v-ms`` (SDEdit over VideoCrafter2, configs/011_v2v/
    v2v_ms.yaml: strength 0.4, so 20 of 50 DDIM steps, CFG 7.5) and the
    enhancement model (``V2VEnhanceFlow``, configs/011_v2v/
    v2v_enhance_unet.yaml: the UNet with 8 input channels, noise-augmented
    conditioning latents, all 50 steps) through ``cli/v2v``, both at full
    width and depth with random weights from the seed."""
    from videotuna_tpu_torch.cli.commands import main as command
    from videotuna_tpu_torch.cli.v2v import run_v2v
    return [_run_v2v(A, "e2e-v2v-ms", [V2V_COMMAND], V2V_SDEDIT_STEPS,
                     command),
            _run_v2v(A, "e2e-v2v-enhance", ["--config", CONFIG_V2V_UNET],
                     V2V_ENHANCE_STEPS,
                     lambda argv: 0 if run_v2v(argv)["videos"] else 1)]


@tf32_off()
def check_small_reference_v2v(control: float = 0.0) -> None:
    """The enhancement model (``V2VEnhanceFlow``) at narrow width
    (``_narrow_vc``: the UNet in f32) on the card and on the CPU with the
    same weights, clip, prompt, posterior and augmentation noise and x_T,
    TF32 off: a 4×128×256 clip gives 16×32 latents, 512 tokens at level 1
    (K2) and 128 at level 2 (K1) on flash_fwd.cu's f32 path.  The
    conditioning latents, one UNet call on [x | z_cond] and the enhanced
    pixels after the DDIM steps with CFG must agree.

    With ``control`` > 0 every card attention output is scaled by 1 +
    ``control``, and the check must then fail."""
    import videotuna_tpu_torch.kernels.attention as A
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    flash = A.flash_attention

    def scaled(*args, **kwargs):
        out = flash(*args, **kwargs)
        return out * (1 + control) if out.is_cuda else out

    cfg = load_configs([CONFIG_V2V_UNET], _narrow_vc(False))
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    frames, height, width = 4, 128, 256
    shape = cpu.latent_shape(1, frames, height, width)
    gen = torch.Generator().manual_seed(3)
    video = torch.rand((1, frames, height, width, 3), generator=gen) * 2 - 1
    post, aug, x_T = (torch.randn(shape, generator=gen) for _ in range(3))
    t = torch.tensor([int(cpu.scheduler.timesteps[1])])
    outs, launches = [], {}
    if control:
        A.flash_attention = scaled
    try:
        for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
            cond = flow.encode_text([V2V_PROMPT])
            uncond = flow.encode_text([""])
            z_cond = flow._prepare_cond_latents(
                video.to(dev), None, 0.4, post.to(dev), aug.to(dev))
            zero_counts(A)
            with torch.inference_mode():
                call = flow.denoise_apply(x_T.to(dev), t.to(dev),
                                          dict(cond, z_cond=z_cond))
            launches = {k: v for k, v in read_counts(A).items() if v}
            out = flow.enhance(video.to(dev), cond, None, 0.4, 7.5, uncond,
                               posterior_noise=post.to(dev),
                               noise=aug.to(dev), x_T=x_T.to(dev))
            outs.append([x.float().cpu() for x in (z_cond, call, out)])
    finally:
        A.flash_attention = flash
    # one UNet call (B = 4 frames): level 1's 3 spatial transformers on K2,
    # level 2's on K1, each a self- and a text cross-attention
    if launches != {"K2": 6, "K1": 6}:
        raise AssertionError(f"narrow V2V UNet call on the card launched "
                             f"{launches}")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(a, b) for a, b in zip(outs[1], outs[0])]
    tols = (REF_TOL_DECODE, REF_VC_TOL_CALL, REF_TOL_DECODE)
    ok = all(math.isfinite(e) and e <= tol for e, tol in zip(errs, tols))
    log("reference-v2v", what="narrow v2v_enhance_unet flow, cuda vs cpu",
        control=control, latent_shape=list(shape),
        steps=gpu.scheduler.num_steps, cfg=7.5, card_launches=launches,
        rel_errs=[f"{e:.3e}" for e in errs], tols=list(tols), ok=ok)
    if control and ok:
        raise AssertionError(f"reference-v2v passed with every card "
                             f"attention output scaled by 1 + {control}")
    if not control and not ok:
        raise AssertionError("GPU V2V enhancement flow disagrees with the "
                             "CPU flow")
    del cpu, gpu
    _free()


def run_flux_v2v(A) -> tuple:
    """The Flux and V2V phases in order: (K-flux's records, the Flux
    sampling runs, the LoRA training run, the V2V runs)."""
    kflux = timed_phase("K-flux", check_k_flux, A)
    check_small_reference_flux(A)
    flux = [timed_phase("e2e-flux-dev", run_e2e_flux, A, FLUX_DEV_COMMAND,
                        FLUX_DEV_STEPS),
            timed_phase("e2e-flux-schnell", run_e2e_flux, A,
                        FLUX_SCHNELL_COMMAND, FLUX_SCHNELL_STEPS)]
    train = timed_phase("train-flux-lora", run_train_flux, A)
    v2v = timed_phase("e2e-v2v", run_e2e_v2v, A)
    check_small_reference_v2v()
    check_small_reference_v2v(control=REF_VC_CONTROL)
    return kflux, flux, train, v2v


# ---------------------------------------------------------------- phases 58-64
CONFIG_HY_I2V = os.path.join(ROOT, "configs", "007_hunyuanvideo",
                             "hunyuanvideo_i2v.yaml")
HY_I2V_COMMAND = "inference-hunyuan-i2v-720p"
HY_I2V_PROMPT = "a red panda climbing a snow-covered pine tree at dawn"
LLAVA_LAYERS = 24            # ViT-L/14-336: one f32 K1 (577 tokens, d=64) each
LLAVA_TOKENS = (336 // 14) ** 2 + 1
# the I2V template's 359 ids (256 text + 103) with the <image> slot
# spliced with 576 states
I2V_LLAMA_TOKENS = 256 + 103 - 1 + 576
CONFIG_OS12 = os.path.join(ROOT, "configs", "003_opensora",
                           "opensorav12_stdit3_720p.yaml")
CONFIG_OS12_PAIRED = os.path.join(ROOT, "configs", "003_opensora",
                                  "opensorav12_stdit8_paired.yaml")
OS12_PROMPT = "a lighthouse on a cliff above a stormy sea, waves breaking"
OS12_STEPS = 30              # the config's every step
# of them in the whole run, cut to keep it inside its time with the serving
# phases (every step costs the same; --opensora12 alone runs all 30)
OS12_WHOLE_STEPS = 4
OS12_DEPTH = 28
OS12_FRAMES = 30             # the config's input_size: 30 × 90 × 160 latents
OS12_SIZE = (720, 1280)
OS12_TOKENS = (720 // 16) * (1280 // 16)     # 3,600 a frame
OS12_TEXT = 300              # T5 tokens: the cross-attention's keys
# the config has no inference section: the size and length its input_size
# names, set by overrides
OS12_OVERRIDES = [f"inference.frames={OS12_FRAMES}",
                  f"inference.height={OS12_SIZE[0]}",
                  f"inference.width={OS12_SIZE[1]}"]
OS12_REF_STEPS = 3           # narrow Open-Sora 1.2 card-vs-CPU trajectory
# K-f32: (label, route, B, Sq, Sk, H, d, causal): the LLaVA tower's and the
# CLIP image embedder's f32 attention, and the LLaMA's over the I2V
# prompt's spliced sequence
F32_CASES = [
    ("K1 f32 llava", "K1", 1, LLAVA_TOKENS, LLAVA_TOKENS, 16, 64, False),
    ("K2 f32 clip", "K2", 1, 256, 256, 16, 80, False),
    ("K2 f32 llama i2v", "K2", 1, I2V_LLAMA_TOKENS, I2V_LLAMA_TOKENS,
     HY_LLAMA_HEADS, 128, True),
]


def check_k_f32(A) -> dict:
    """The f32 design (flash_fwd_f32_sm90.cu) at the widths this slice's
    paths reach it, as they call it (``flash_fwd`` on the route
    ``flash_attention`` picks): the LLaVA tower (d = 64, 577², 16 heads,
    route K1), the CLIP ViT-H/14 image embedder (d = 80, 256², 16 heads,
    split into key ranges) and the LLaMA over the I2V prompt (d = 128,
    causal, 934 tokens, 32 heads), against the f32 plain version (F32_TOL
    of max|o|, the LSE absolute), counted on the f32 design; each timed by
    CUDA events, device time (CUDA-graph replay) and host time beside the
    old design (flash_fwd.cu on the same tensors, in turns: new, old, old,
    new), SDPA's fastest backend and the bound, which counts each product
    as three bf16 products."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    gen = torch.Generator(device="cuda").manual_seed(58)
    recs = {}
    for label, route, b, sq, sk, h, d, causal in F32_CASES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   for s in (sq, sk, sk))
        kw = dict(sm_scale=d ** -0.5, causal=causal)
        plan = A._fwd_plan("f32", q, k, causal, False)
        before = (A.flash_fwd.launches[route],
                  A.flash_fwd.launches_f32[route],
                  A.flash_fwd.launches_split[route])
        out, lse = A.flash_fwd(q, k, v, emit_lse=True, route=route, **kw)
        t0 = time.perf_counter()
        ref, ref_lse = A.flash_fwd_plain(q, k, v, emit_lse=True, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        launched = (A.flash_fwd.launches[route],
                    A.flash_fwd.launches_f32[route],
                    A.flash_fwd.launches_split[route])
        err = (out - ref).abs().max().item()
        tol = F32_TOL * ref.abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        expected = (before[0] + 1, before[1] + 1,
                    before[2] + (plan.splits > 1))
        ok = (err <= tol and lse_err <= F32_TOL and launched == expected
              and A._fwd_design(route, q.dtype, d, causal, None, True,
                                None) == "f32")

        def new():
            return A.flash_fwd(q, k, v, route=route, **kw)

        def old():
            return A._flash_fwd_mma(q, k, v, kw["sm_scale"], causal, None,
                                    None, False)

        old_err = (old() - ref).abs().max().item()
        log("K-f32", case=label, shape=f"B{b}xSq{sq}xSk{sk}xH{h}xd{d}",
            route=route, kernel="flash_fwd_f32_sm90", causal=causal,
            splits=plan.splits, max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
            lse_err=f"{lse_err:.3e}", lse_tol=F32_TOL,
            old_design_max_abs_err=f"{old_err:.3e}", ok=ok)
        if not ok or old_err > tol:
            raise AssertionError(f"K-f32 {label}: disagrees with its plain "
                                 f"version, or launched {launched} "
                                 f"(expected {expected})")
        del out, lse, ref, ref_lse
        pairs = sq * (sk + 1) / 2 if causal else sq * sk
        flops = 4.0 * b * h * pairs * d
        bound_ms, bound_by = _bound(3 * flops, 4 * q.numel() * 4)
        dev = [device_ms(fn, reps=50) for fn in (new, old, old, new)]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        skw = {"is_causal": True} if causal else {}
        library_ms, backend = sdpa_ms((qt, kt, vt), skw, reps=50)
        lib_dev, dev_backend = sdpa_device_ms((qt, kt, vt), skw, reps=50)
        del qt, kt, vt
        rec = dict(max_abs_err=err, lse_err=lse_err,
                   ms=cuda_time_ms(new, reps=50),
                   device_ms=min(dev[0], dev[3]), host_ms=host_ms(new, 200),
                   old_design_ms=cuda_time_ms(old, reps=50),
                   old_design_device_ms=min(dev[1], dev[2]),
                   old_design_host_ms=host_ms(old, 200),
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, library_device_ms=lib_dev,
                   splits=plan.splits)
        log("K-f32", case=f"{label} timing", kernel="flash_fwd_f32_sm90",
            ms=f"{rec['ms']:.4f}", device_ms=f"{rec['device_ms']:.4f}",
            device_ms_turns="/".join(f"{x:.4f}" for x in dev),
            host_ms=f"{rec['host_ms']:.4f}",
            old_design_ms=f"{rec['old_design_ms']:.4f}",
            old_design_device_ms=f"{rec['old_design_device_ms']:.4f}",
            old_design_host_ms=f"{rec['old_design_host_ms']:.4f}",
            beats_old_by_device=rec["device_ms"]
            < rec["old_design_device_ms"],
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            plain_ms=f"{plain_ms:.3f}",
            library=f"scaled_dot_product_attention[{backend}]",
            library_ms=f"{library_ms:.4f}",
            library_device=f"scaled_dot_product_attention[{dev_backend}]",
            library_device_ms=f"{lib_dev:.4f}")
        recs[label] = rec
        del q, k, v
        _free()
    return recs


def _flow_shell(cfg, device: str = "cuda"):
    """A HunyuanVideoFlow holding only its text stages (the LLaMA and the
    CLIP-L of ``cfg``, on ``device``, seeded): what ``encode_text_i2v``
    reads, without the 13B DiT and the VAE."""
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.flows.hunyuan import HunyuanVideoFlow
    from videotuna_tpu_torch.models.layers import init_weights_
    params = cfg["flow"]["params"]
    flow = HunyuanVideoFlow.__new__(HunyuanVideoFlow)
    flow.device = torch.device(device)
    flow.tokenizer = params.get("tokenizer")
    flow.model_max_length = int(params.get("model_max_length", 256))
    for i, name in enumerate(("cond_stage", "cond_stage_2")):
        with torch.device("meta"):
            module = instantiate(params[f"{name}_config"])
        module = module.to_empty(device=device).eval()
        init_weights_(module, torch.Generator(device=device).manual_seed(i))
        setattr(flow, name, module)
    return flow


def run_hunyuan_i2v_encode(A) -> dict:
    """The full I2V prompt chain at full width on a seeded 720×1280 image
    and a prompt: the LLaVA tower (``CLIPVisionEncoder`` ViT-L/14 at 336
    px, ``feature_layer=-2``, f32: 24 f32 attentions of d=64 over 577
    tokens, route K1) and ``LlavaProjector`` (1024 → 4096) through
    ``LlavaCaptioner.image_tokens`` (576 states), then the flow's
    ``encode_text_i2v`` (the LLaMA 4096×32 in f32 over 934 tokens, 32 f32
    K2, and CLIP-L's pooled state) for token replace and latent concat.
    Asserts the shapes of y and mask (144 or 288 image rows before 252
    text rows), finite states, and the launches: the tower's K1 and the
    LLaMA's K2 all on the f32 design, unsplit, no other."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.models.clip_vision import CLIPVisionEncoder
    from videotuna_tpu_torch.models.layers import init_weights_
    from videotuna_tpu_torch.tools.captioner import (LlavaCaptioner,
                                                     LlavaProjector)
    _free()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(59)
    with torch.device("meta"):
        tower = CLIPVisionEncoder(image_size=336, feature_layer=-2)
        proj = LlavaProjector(1024, 4096)
    tower = tower.to_empty(device="cuda").eval()
    proj = proj.to_empty(device="cuda").eval()
    init_weights_(tower, gen)
    init_weights_(proj, gen)
    flow = _flow_shell(load_configs([CONFIG_HY_I2V]))
    image = torch.rand((1, *HY_TRAIN_SIZE, 3), generator=gen,
                       device="cuda") * 2 - 1
    zero_counts(A)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = LlavaCaptioner(tower, proj).image_tokens(image)[None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tower_launches = read_counts(A)
    out, secs = {}, {}
    for kind in ("token_replace", "latent_concat"):
        t = time.perf_counter()
        out[kind] = flow.encode_text_i2v([HY_I2V_PROMPT], states, kind)
        torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t
    launches, sm90 = read_counts(A), read_sm90_counts(A)
    peak = torch.cuda.max_memory_allocated()
    shapes = {k: [list(c["y"].shape), list(c["mask"].shape),
                  list(c["pooled"].shape)] for k, c in out.items()}
    log("hunyuan-i2v-encode", image="1x720x1280", tower="ViT-L/14-336 f32",
        tower_tokens=LLAVA_TOKENS, image_states=list(states.shape),
        llama_tokens=I2V_LLAMA_TOKENS, shapes=shapes,
        tower_and_projector_sec=f"{t1 - t0:.3f}",
        encode_token_replace_sec=f"{secs['token_replace']:.3f}",
        encode_latent_concat_sec=f"{secs['latent_concat']:.3f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", tower_launches=tower_launches,
        launches=launches, sm90_launches=sm90)
    n = 2 * HY_LLAMA_LAYERS
    split = sum(v for k, v in sm90.items() if k.endswith("_split"))
    if tuple(states.shape) != (1, 576, 4096) \
            or shapes["token_replace"][:2] != [[1, 144 + 252, 4096],
                                               [1, 144 + 252]] \
            or shapes["latent_concat"][:2] != [[1, 288 + 252, 4096],
                                               [1, 288 + 252]] \
            or not all(torch.isfinite(c["y"]).all() for c in out.values()):
        raise AssertionError(f"hunyuan-i2v-encode: states {states.shape}, "
                             f"shapes {shapes}")
    if tower_launches != dict({k: 0 for k in launches}, K1=LLAVA_LAYERS) \
            or launches != dict({k: 0 for k in launches}, K1=LLAVA_LAYERS,
                                K2=n) \
            or (sm90["K1_f32"], sm90["K2_f32"], split) \
            != (LLAVA_LAYERS, n, 0):
        raise AssertionError(f"hunyuan-i2v-encode: launches {launches}, "
                             f"{sm90}: expected the tower's {LLAVA_LAYERS} "
                             f"K1 and the LLaMA's {n} K2 on the f32 design, "
                             "unsplit, no other")
    del tower, proj, flow, out, states
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                tower_sec=t1 - t0, encode_sec=secs)


def run_e2e_hunyuan_i2v(A) -> dict:
    """HunyuanVideo I2V through the registry's ``inference-hunyuan-i2v-720p``
    as shipped (``hunyuanvideo_i2v.yaml``: i2v_mode, latent concat; its
    in_channels 33 read as the concat's 32, ROADMAP.md queue 3) at full
    width and depth (dim 3072, 20 double and 40 single blocks, bf16; LLaMA
    4096×32 and CLIP-L in f32; HunyuanVAE), random weights from the seed,
    from one seeded 1280×720 PNG (``inference.input_dir``: the config's
    prompt_dir does not exist) at 129×720×1280.  Cuts: 1 of the 50 steps,
    the first 2 latent frames decoded (5 pixel frames), as ``e2e-hunyuan``.
    Asserts K3 60 a step on K3's kernel at d = 128, the LLaMA's 32 f32 K2
    on the split f32 design, no other launch (the VAE's attention is
    512 wide: the math path), finite latents and pixels, the video and
    metric.json."""
    inputs = _i2v_inputs("e2e_hunyuan_i2v", HY_TRAIN_SIZE, HY_I2V_PROMPT)
    cuts = [f"flow.params.scheduler_config.params.num_steps={HY_STEPS}",
            f"inference.decode_latent_frames={HY_DECODE_LATENT_FRAMES}"]
    launches, sm90, m, video, wall, peak = _run_command(
        A, "e2e-hunyuan-i2v",
        [HY_I2V_COMMAND, f"inference.input_dir={inputs}", *cuts],
        "e2e_hunyuan_i2v")
    frames = 1 + 4 * (HY_DECODE_LATENT_FRAMES - 1)
    k3 = HY_DEPTH * HY_STEPS
    log("e2e-hunyuan-i2v", command=HY_I2V_COMMAND, cuts=" ".join(cuts),
        frames_sampled=129, height=720, width=1280, tokens=SHAPE_HY["s"],
        in_channels=32, steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        image_encode_sec=f"{m['image_encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", decoded_frames=frames,
        run_sec=f"{wall:.1f}", peak_mem_gb=f"{peak / 1e9:.2f}",
        latent_shape=m["latent_shape"], launches=launches,
        sm90_launches=sm90, video_shape="x".join(map(str, video.shape)))
    expected = dict({k: 0 for k in launches}, K3=k3, K2=HY_LLAMA_LAYERS)
    if m["denoise_steps"] != HY_STEPS or launches != expected \
            or (sm90["K3"], sm90["K3_d128"], sm90["tma_copies"]) \
            != (k3, k3, 0) \
            or m["latent_shape"] != [1, 33, 90, 160, 16] \
            or not m["image_encode_sec"] > 0 \
            or tuple(video.shape) != (frames, 720, 1280, 3):
        raise AssertionError(f"e2e-hunyuan-i2v: launches {launches}, {sm90}, "
                             f"latents {m['latent_shape']}, video "
                             f"{video.shape}: expected {expected}, K3 on "
                             "K3's kernel, no copy")
    check_split_counts("e2e-hunyuan-i2v", sm90, llama=HY_LLAMA_LAYERS)
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                sec_per_step=m["sample_sec"] / m["denoise_steps"],
                text_encode_sec=m["encode_sec"],
                image_encode_sec=m["image_encode_sec"],
                decode_sec=m["decode_sec"])


def _image_cond(size, frames):
    """A ``_flow_card_vs_cpu`` condition: the I2V latent concat of one
    seeded image at ``size`` (H, W) with a fixed posterior draw, the same
    on both devices."""
    h, w = size
    image = torch.rand((1, h, w, 3), generator=torch.Generator()
                       .manual_seed(3)) * 2 - 1

    def condition(flow, cond, dev):
        lat = flow.latent_shape(1, frames, h, w)
        post = torch.randn((1, 1, *lat[2:]),
                           generator=torch.Generator().manual_seed(4))
        return flow.prepare_image_cond(cond, None, image.to(dev), frames, h,
                                       w, posterior_noise=post.to(dev))[0]
    return condition


@tf32_off()
def check_small_reference_hunyuan_i2v(A) -> None:
    """The narrow HunyuanVideo I2V flow (``hunyuanvideo_i2v.yaml`` with
    ``_narrow_hunyuan``'s widths: d = 128 kept) on the card and on the CPU
    with the same weights, prompt, image latents and x_T, TF32 off: its DiT
    in bf16 and in f32, with ``i2v_condition_type`` None and token
    replace (9×128×128: 3×16×16 latents, 192 + 160 joint tokens: K3 and
    the f32 K2 on the card's path); then a control that must fail: the
    f32 token-replace flow with the card's DiT modulating the first frame
    with vec in place of vec_tr."""
    from videotuna_tpu_torch.core.config import load_configs
    den = "flow.params.denoiser_config.params"
    size = (9, 128, 128)
    cases = [(dtype, kind) for kind in (None, "token_replace")
             for dtype in ("bfloat16", "float32")]
    for dtype, kind in cases + [("float32", "control")]:
        cfg = load_configs([CONFIG_HY_I2V], _narrow_hunyuan() + [
            f"flow.params.scheduler_config.params.num_steps={HY_REF_STEPS}",
            f"{den}.dtype={dtype}",
            f"{den}.i2v_condition_type="
            f"{'null' if kind is None else 'token_replace'}"])
        design = "K3_d128" if dtype == "bfloat16" else "K3_f32"
        n = 3 * (1 + HY_REF_STEPS)
        tols = ((REF_TOL_CALL, REF_TOL_TRAJ, REF_TOL_DECODE)
                if dtype == "bfloat16" else
                (REF_VC_TOL_CALL, REF_VC_TOL_TRAJ, REF_TOL_DECODE))
        _flow_card_vs_cpu(
            A, f"reference-hunyuan-i2v {dtype} {kind}", cfg, size,
            lambda flow: flow.scheduler.timesteps[1].reshape(1),
            "a panda playing guitar by a lake", {"K3": n, "K2": 2},
            {design: n}, tols, condition=_image_cond(size[1:], size[0]),
            card=(lambda flow: setattr(flow.denoiser, "token_replace",
                                       False)) if kind == "control"
            else None, control=kind == "control")


def _os12_launches(paired: bool, depth: int = OS12_DEPTH) -> tuple:
    """(K2, K4) launches of one Open-Sora 1.2 denoiser call of ``depth``
    layers: a spatial self-attention a layer (K2; the temporal one is
    under 128 frames: the math path) and a cross-attention a block (K4;
    the paired layout's two blocks a layer each have one)."""
    return depth, depth * (2 if paired else 1)


def _held_case(A, phase, label, route, qq, kk, vv, kv_valid) -> dict:
    """One bf16 d = 72 call as a main path makes it (route K2 unmasked, K4
    with the key mask ``kv_valid``) on the persistent kernel of
    flash_fwd_sm90.cu, against the plain version (a block of query rows at
    a time), counted on the Hopper design and unsplit; timed by CUDA events
    and device time beside its bound, the old design (flash_fwd.cu) on the
    same tensors and SDPA's fastest backend (with the boolean mask for
    K4).  The bound counts the kept keys of each row only."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    h, d = qq.shape[2], qq.shape[3]
    kw = dict(sm_scale=d ** -0.5, kv_valid=kv_valid)

    def new():
        return A.flash_fwd(qq, kk, vv, route=route, **kw)

    def old():
        return A._flash_fwd_mma(qq, kk, vv, d ** -0.5, False, kv_valid,
                                None, False)

    before = (A.flash_fwd.launches_sm90[route],
              A.flash_fwd.launches_split[route])
    out = new()
    torch.cuda.synchronize()
    launched = (A.flash_fwd.launches_sm90[route],
                A.flash_fwd.launches_split[route])
    t0 = time.perf_counter()
    # the plain version a block of rows at a time (scores ≤ 4 GB)
    rows = max(128, int(1e9 / (qq.shape[0] * h * kk.shape[1])) // 128 * 128)
    ref = _plain_masked_chunked(A, qq, kk, vv, kv_valid, None, rows)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out.float() - ref.float()).abs().max().item()
    tol = FWD_TOL * ref.float().abs().max().item()
    old_err = (old().float() - ref.float()).abs().max().item()
    ok = (err <= tol and old_err <= tol
          and launched == (before[0] + 1, before[1]))
    log(phase, case=label, shape=f"B{qq.shape[0]}xSq{qq.shape[1]}x"
        f"Sk{kk.shape[1]}xH{h}xd{d}", route=route,
        kernel="flash_fwd_sm90 persistent", max_abs_err=f"{err:.3e}",
        tol=f"{tol:.3e}", old_design_max_abs_err=f"{old_err:.3e}",
        plain_ms=f"{plain_ms:.1f}", ok=ok)
    if not ok:
        raise AssertionError(f"{phase} {label}: disagrees with its plain "
                             f"version, or launched {launched} (from "
                             f"{before}: one Hopper launch, unsplit)")
    del out, ref
    _free()
    if kv_valid is None:
        scores = qq.shape[0] * h * qq.shape[1] * kk.shape[1]
        io_bytes = 4 * qq.numel() * 2
    else:   # the kept keys of each row only
        scores = h * qq.shape[1] * int(kv_valid.sum())
        io_bytes = (2 * qq.numel() + 2 * kk.numel()) * 2 + kv_valid.numel()
    exp2_ms = _exp2_floor_ms(scores)
    bound_ms, bound_by = _bound(4.0 * scores * d, io_bytes, exp2_ms)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kk, vv))
    skw = ({} if kv_valid is None
           else {"attn_mask": kv_valid[:, None, None, :]})
    library_ms, backend = sdpa_ms((qt, kt, vt), skw, reps=10)
    lib_dev, dev_backend = sdpa_device_ms((qt, kt, vt), skw, 5)
    del qt, kt, vt
    _free()
    rec = dict(max_abs_err=err, ms=cuda_time_ms(new, reps=10),
               device_ms=device_ms(new, 5),
               old_design_ms=cuda_time_ms(old, reps=10),
               old_design_device_ms=device_ms(old, 5),
               ms_again=cuda_time_ms(new, reps=10), plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, library_device_ms=lib_dev)
    log(phase, case=f"{label} timing",
        kernel="flash_fwd_sm90 persistent", ms=f"{rec['ms']:.4f}",
        ms_again=f"{rec['ms_again']:.4f}",
        device_ms=f"{rec['device_ms']:.4f}",
        old_design_ms=f"{rec['old_design_ms']:.4f}",
        old_design_device_ms=f"{rec['old_design_device_ms']:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        exp2_floor_ms=f"{exp2_ms:.4f}",
        tflops=f"{4.0 * scores * d / rec['ms'] / 1e9:.1f}",
        of_bound=f"{bound_ms / rec['ms']:.3f}",
        plain_ms=f"{plain_ms:.1f}",
        library=f"scaled_dot_product_attention[{backend}]",
        library_ms=f"{library_ms:.4f}",
        library_device=f"scaled_dot_product_attention[{dev_backend}]",
        library_device_ms=f"{lib_dev:.4f}")
    return rec


def check_k_os12(A) -> dict:
    """Open-Sora 1.2's attention at 720p as the sampling step calls it:
    the spatial K2 (d = 72, online, B = 60: CFG 2 × 30 frames, 3,600
    tokens, 16 heads) and the cross-attention K4 (B = 2, 108,000 queries
    over T5's 300 keys with the prompts' masks: 13 and 1 valid keys), each
    held by ``_held_case``."""
    gen = torch.Generator(device="cuda").manual_seed(60)
    b, s, h, d = 2 * OS12_FRAMES, OS12_TOKENS, 16, 72
    spatial = [_rand((b, s, h, d), gen) for _ in range(3)]
    recs = {"K2 os12 spatial": _held_case(A, "K-os12", "K2 os12 spatial",
                                          "K2", *spatial, None)}
    del spatial
    _free()
    q = _rand((2, OS12_FRAMES * s, h, d), gen)
    k, v = (_rand((2, OS12_TEXT, h, d), gen) for _ in range(2))
    recs["K4 os12 cross"] = _held_case(A, "K-os12", "K4 os12 cross", "K4",
                                       q, k, v,
                                       _lead_mask(2, 0, OS12_TEXT, (13, 1)))
    del q, k, v
    _free()
    return recs


def run_e2e_opensora12(A, steps: int = OS12_STEPS) -> dict:
    """``run_inference`` on configs/003_opensora/opensorav12_stdit3_720p.yaml
    at full width and depth (STDiT3-XL/2: hidden 1152, 28 layers, 16 heads
    of d = 72, qk-norm and temporal RoPE, bf16; T5-XXL in f32 over 300
    tokens; the frame-wise 2D VAE at ch 128), random weights from the seed,
    one prompt at the config's latent size, 30 × 90 × 160 (30 frames at
    720 × 1280: ``OS12_OVERRIDES``, the config having no inference
    section), CFG 7.5 (the default scale), the rectified flow's ``steps``
    Euler steps, every frame decoded.  Asserts 28 spatial K2 and 28 cross
    K4 a step, every one on the persistent kernel of flash_fwd_sm90.cu
    unsplit, with no alignment copy, no other launch (the temporal
    attention over 30 frames and the VAE's 512-wide attention take the
    math path), finite latents and pixels, the video and metric.json."""
    from videotuna_tpu_torch.cli.inference import run_inference
    savedir = os.path.join(OUT_DIR, "e2e_opensora12")
    _free()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(A)
    cuts = [f"flow.params.scheduler_config.params.num_steps={steps}"]
    t0 = time.perf_counter()
    result = run_inference([
        "--config", CONFIG_OS12, "--device", "cuda", "--quiet",
        "--savedir", savedir, "--prompt", OS12_PROMPT, *OS12_OVERRIDES,
        *cuts])
    wall = time.perf_counter() - t0
    launches, sm90 = read_counts(A), read_sm90_counts(A)
    m = result["metrics"]
    peak = torch.cuda.max_memory_allocated()
    video = _read_video(result["videos"][0])
    k2, k4 = _os12_launches(False)
    per = (k2 * steps, k4 * steps)
    h, w = OS12_SIZE
    log("e2e-opensora12", config="opensorav12_stdit3_720p",
        overrides=" ".join(OS12_OVERRIDES + cuts), frames=OS12_FRAMES,
        height=h, width=w, tokens_per_frame=OS12_TOKENS,
        text_tokens=OS12_TEXT, batch="2 (CFG)", steps=m["denoise_steps"],
        sec_per_step=f"{m['sample_sec'] / m['denoise_steps']:.4f}",
        sample_sec=f"{m['sample_sec']:.3f}",
        text_encode_sec=f"{m['encode_sec']:.3f}",
        decode_sec=f"{m['decode_sec']:.3f}", run_sec=f"{wall:.1f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", latent_shape=m["latent_shape"],
        launches=launches, sm90_launches=sm90,
        video_shape="x".join(map(str, video.shape)))
    expected = dict({k: 0 for k in launches}, K2=per[0], K4=per[1])
    if m["denoise_steps"] != steps or launches != expected \
            or (sm90["K2"], sm90["K4"], sm90["tma_copies"]) \
            != (per[0], per[1], 0) \
            or m["latent_shape"] != [1, OS12_FRAMES, h // 8, w // 8, 4] \
            or tuple(video.shape) != (OS12_FRAMES, h, w, 3) \
            or m["nonfinite_latents"] or m["nonfinite_pixels"] \
            or not os.path.isfile(os.path.join(savedir, "metric.json")):
        raise AssertionError(f"e2e-opensora12: launches {launches}, {sm90}, "
                             f"latents {m['latent_shape']}, video "
                             f"{video.shape}: expected {expected}, all on "
                             "flash_fwd_sm90, no copy, finite")
    check_split_counts("e2e-opensora12", sm90)
    del result
    _free()
    return dict(launches=launches, sm90=sm90, peak_gb=peak / 1e9,
                steps=steps, sec_per_step=m["sample_sec"] / steps,
                text_encode_sec=m["encode_sec"], decode_sec=m["decode_sec"])


def _narrow_os12():
    """Open-Sora 1.2 at narrow width, d = 72 kept: STDiT at hidden 144 (2
    heads), depth 2, a 2-layer T5 of dim 64, the VAE at ch 32 with one res
    block, 64 caption tokens."""
    den = "flow.params.denoiser_config.params"
    t5 = "flow.params.cond_stage_config.params"
    return [f"{den}.hidden_size=144", f"{den}.num_heads=2", f"{den}.depth=2",
            f"{den}.caption_channels=64", f"{t5}.dim=64", f"{t5}.heads=2",
            f"{t5}.head_dim=32", f"{t5}.ff_dim=128", f"{t5}.num_layers=2",
            "flow.params.model_max_length=64",
            "flow.params.first_stage_config.params.ch=32",
            "flow.params.first_stage_config.params.num_res_blocks=1",
            f"flow.params.scheduler_config.params.num_steps="
            f"{OS12_REF_STEPS}"]


@tf32_off()
def check_small_reference_opensora12(A) -> None:
    """The narrow Open-Sora 1.2 flows, STDiT3 and the paired STDiT8, on the
    card and on the CPU with the same weights, prompt and x_T, TF32 off
    (2×256×256: 2×32×32 latents, 1,024 spatial tokens a frame (K2), 2,048
    cross queries (K4)): one denoiser call, the latents after the rectified
    flow's 3 steps and the decode; then one narrow rectified-flow training
    step of the STDiT3 in bf16 on both sides (``check_train_reference``'s
    opensora12 case: the loss within 2e-2, the gradients within 3e-2)."""
    from videotuna_tpu_torch.core.config import load_configs
    for config, paired in ((CONFIG_OS12, False), (CONFIG_OS12_PAIRED, True)):
        k2, k4 = (n * (1 + OS12_REF_STEPS)
                  for n in _os12_launches(paired, depth=2))
        _flow_card_vs_cpu(
            A, f"reference-opensora12 {'stdit8' if paired else 'stdit3'}",
            load_configs([config], _narrow_os12()), (2, 256, 256),
            lambda flow: flow.scheduler.timesteps[1].reshape(1),
            "a lighthouse on a cliff", {"K2": k2, "K4": k4},
            {"K2": k2, "K4": k4}, (REF_TOL_CALL, REF_TOL_TRAJ,
                                   REF_TOL_DECODE))
    check_train_reference(A, only=("opensora12",))


def profile_opensora12_call() -> dict:
    """One full-width STDiT3-XL/2 call at 720p with CFG (B=2, 30×90×160
    latents, 300 caption tokens with 13 and 1 valid), the work of one
    sampling step: timed with CUDA events and traced with torch.profiler,
    device time by kernel group (the flash kernels, GEMMs, LayerNorm, the
    rest) and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.models.layers import init_weights_
    _free()
    cfg = load_configs([CONFIG_OS12])["flow"]["params"]["denoiser_config"]
    with torch.device("meta"):
        model = instantiate(cfg)
    model = model.to_empty(device="cuda").eval()
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((2, OS12_FRAMES, 90, 160, 4), generator=gen,
                    device="cuda")
    t = torch.tensor([500.0, 500.0], device="cuda")
    y = torch.randn((2, OS12_TEXT, 4096), generator=gen, device="cuda")
    mask = _lead_mask(2, 0, OS12_TEXT, (13, 1))
    with torch.inference_mode():
        call_ms = cuda_time_ms(lambda: model(x, t, y, mask), reps=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x, t, y, mask)
            torch.cuda.synchronize()
    del model
    _free()
    return _log_profile(
        "profile-opensora12", "one STDiT3-XL/2 call at 30×720×1280, CFG "
        "batch 2", prof, call_ms, "flash_fwd (K2+K4)",
        extra_groups=(("layernorm", ("layer_norm", "layernorm")),))


def run_hunyuan_i2v(A) -> tuple:
    """The HunyuanVideo I2V phases in order: (K-f32's records, the encode
    run, the sampling run)."""
    kf32 = timed_phase("K-f32", check_k_f32, A)
    enc = timed_phase("hunyuan-i2v-encode", run_hunyuan_i2v_encode, A)
    check_small_reference_hunyuan_i2v(A)
    e2e = timed_phase("e2e-hunyuan-i2v", run_e2e_hunyuan_i2v, A)
    return kf32, enc, e2e


def run_opensora12(A, steps: int = OS12_STEPS) -> tuple:
    """The Open-Sora 1.2 phases in order: (K-os12's records, the sampling
    run)."""
    kos = timed_phase("K-os12", check_k_os12, A)
    check_small_reference_opensora12(A)
    e2e = timed_phase("e2e-opensora12", run_e2e_opensora12, A, steps)
    return kos, e2e


# ---------------------------------------------------------------- phases 66-72
SERVE_SLOTS = 4
SERVE_FRAMES = 16            # the config's 16×256×256: 16×32×32 latents
SERVE_SIZE = 256
SERVE_TOKENS = (SERVE_SIZE // 16) ** 2        # 256 spatial tokens a frame
SERVE_TEXT = 120             # T5 tokens: the cross-attention's keys
SERVE_TIMEOUT = 600          # seconds: every HTTP call and thread join
SERVE_PROMPTS = [
    "a red panda eating bamboo in a misty forest",
    "a sailboat crossing a calm bay at sunrise",
    "a hot air balloon drifting over a canyon",
    "a cat chasing a paper butterfly across a wooden floor",
    "fireworks bursting over a snowy mountain village",
    "a hummingbird hovering beside a red flower",
]
SERVE_TIMED_STEPS = 5        # engine steps timed at each occupancy
INT8_BYTES_GATE = 0.55       # int8 denoiser bytes, of bf16's
INT8_REL_GATE = 0.05         # w8a8 vs bf16, tests/test_int8.py's gate
SERVE_REF_BOARD = (0, 1, 3)  # narrow engines: the step each request boards


def _http(url, payload=None):
    """(status, JSON body) of a GET, or of a POST of ``payload``, with the
    call's timeout."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def _serving(server):
    """The server's loop in a thread of this process on 127.0.0.1, an
    ephemeral port; shut down on the way out with its service's worker."""
    import threading
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=SERVE_TIMEOUT)
        if hasattr(server.service, "shutdown"):
            server.service.shutdown()


def _posts(url, payloads) -> list:
    """POST each payload to /generate from a thread of its own, at once;
    the (status, body) of each, in order."""
    import threading
    out = [None] * len(payloads)

    def run(i):
        out[i] = _http(url + "/generate", payloads[i])
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: a request did not return in time")
    return out


def _wait_for(cond, what: str) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > SERVE_TIMEOUT:
            raise AssertionError(f"serve: timed out waiting for {what}")
        time.sleep(0.01)


def _served(tag: str, replies, n: int, **expect) -> None:
    """Every reply 200 with one video of the configuration's size on disk,
    and the fields ``expect``."""
    bad = [r for r in replies if r[0] != 200
           or any(r[1].get(k) != v for k, v in expect.items())]
    if len(replies) != n or bad:
        raise AssertionError(f"{tag}: replies {replies}")
    for _, body in replies:
        video = _read_video(body["videos"][0])
        if tuple(video.shape) != (SERVE_FRAMES, SERVE_SIZE, SERVE_SIZE, 3):
            raise AssertionError(f"{tag}: video shape {video.shape}")


def _serve_window(A, tag: str, per_call: int, calls: int) -> dict:
    """The launches since the counts were set to 0: K2 and K4 ``per_call``
    × ``calls`` each (28 layers a denoiser call), all on flash_fwd_sm90
    unsplit, no other launch."""
    launches, sm90 = read_counts(A), read_sm90_counts(A)
    n = per_call * calls
    expected = dict({k: 0 for k in launches}, K2=n, K4=n)
    if launches != expected or (sm90["K2"], sm90["K4"], sm90["tma_copies"]) \
            != (n, n, 0):
        raise AssertionError(f"{tag}: launches {launches}, {sm90}; expected "
                             f"{expected} on flash_fwd_sm90, no copy")
    check_split_counts(tag, sm90)
    return dict(launches=launches, sm90=sm90)


def _engine_seconds(flow, occupancy, reqs, cfg_scale) -> tuple:
    """({occupancy: seconds per step}, the engine) of a fresh 4-slot
    engine at each occupancy of ``occupancy`` (requests boarded one by
    one), host clock around synchronised steps."""
    from videotuna_tpu_torch.serving import ContinuousBatchEngine
    eng = ContinuousBatchEngine(flow, slots=SERVE_SLOTS,
                                frames=SERVE_FRAMES, height=SERVE_SIZE,
                                width=SERVE_SIZE, cfg_scale=cfg_scale)
    out = {}
    for n in occupancy:
        while eng.n_active < n:
            eng.submit(*reqs[eng.n_active])
        eng.step()                   # boards the new slot's tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_TIMED_STEPS):
            eng.step()
        torch.cuda.synchronize()
        out[n] = (time.perf_counter() - t0) / SERVE_TIMED_STEPS
    return out, eng


def _engine_requests(flow, n):
    """(x_T, cond, uncond) of ``n`` requests on the card: seeded x_T, the
    prompts' and the empty prompt's T5 states."""
    uncond = flow.encode_text([""])
    shape = flow.latent_shape(1, SERVE_FRAMES, SERVE_SIZE, SERVE_SIZE)
    gen = torch.Generator("cuda").manual_seed(70)
    return [(torch.randn(shape, generator=gen, device="cuda"),
             flow.encode_text([SERVE_PROMPTS[i]]), uncond)
            for i in range(n)]


def check_k_serve(A) -> dict:
    """STDiT-XL/2's attention at the 4-slot engine's shapes (B = 2·4 =
    8 under CFG): the spatial K2 over B = 8 × 16 frames = 128 sequences
    of 256 tokens and the cross-attention K4 (B = 8, 4,096 queries over
    120 T5 keys, the prompts' masks: the four prompts' 13, 11, 9, 7 valid
    keys, the empty prompt's 1), each held by ``_held_case``."""
    gen = torch.Generator(device="cuda").manual_seed(66)
    b = 2 * SERVE_SLOTS
    spatial = [_rand((b * SERVE_FRAMES, SERVE_TOKENS, 16, 72), gen)
               for _ in range(3)]
    recs = {"K2 serve spatial": _held_case(A, "K-serve", "K2 serve spatial",
                                           "K2", *spatial, None)}
    q = _rand((b, SERVE_FRAMES * SERVE_TOKENS, 16, 72), gen)
    k, v = (_rand((b, SERVE_TEXT, 16, 72), gen) for _ in range(2))
    mask = _lead_mask(b, 0, SERVE_TEXT, (13, 11, 9, 7, 1, 1, 1, 1))
    recs["K4 serve cross"] = _held_case(A, "K-serve", "K4 serve cross", "K4",
                                        q, k, v, mask)
    del spatial, q, k, v
    _free()
    return recs


def _drive_engine(engine, reqs, board_at=SERVE_REF_BOARD) -> dict:
    """Board request j before step ``board_at[j]``, step until every
    request completes: {request: final latents on the CPU}."""
    slot_of, got = {}, {}
    for step in range(200):
        for j, at in enumerate(board_at):
            if at == step:
                slot_of[engine.submit(*reqs[j])] = j
        engine.step()
        for slot, z in engine.poll_completed():
            got[slot_of.pop(slot)] = z.float().cpu()
        if len(got) == len(reqs):
            return got
    raise AssertionError(f"engine did not drain: {sorted(got)}")


def _narrow_pair(cfg, quantize=False):
    """A narrow flow on the CPU and the card with the same seeded weights
    (each quantized by its own ``quantize_int8`` after the copy)."""
    from videotuna_tpu_torch.core.registry import instantiate
    cpu = instantiate(cfg["flow"], device="cpu")
    gpu = instantiate(cfg["flow"], device="cuda")
    cpu.init_params(seed=1)
    for name, module in cpu.components().items():
        gpu.components()[name].load_state_dict(module.state_dict())
    if quantize:
        cpu.quantize_int8()
        gpu.quantize_int8()
    return cpu, gpu


def _rel(a, b) -> float:
    return ((a.float().cpu() - b.float().cpu()).abs().max()
            / b.float().cpu().abs().max()).item()


@tf32_off()
def check_small_reference_serve(A) -> None:
    """The engine card vs CPU in f32, TF32 off: staggered arrivals (3
    requests boarding at steps 0, 1 and 3 of a 3-slot engine, CFG) on
    tiny_t2v.yaml's DDIM flow (4 steps) and on the narrow HunyuanVideo
    flow (flow matching, the DiT in f32, K3 on the card's path); then the
    tiny flow int8-quantized on both sides: one w8a8 denoiser call and its
    2 DDIM steps (the card's product on torch._int_mm, rows padded).  A
    call within 1e-4·max, the latents within 1e-3·max (the narrow checks'
    f32 tolerances)."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.serving import ContinuousBatchEngine
    den = "flow.params.denoiser_config.params"
    tiny = os.path.join(ROOT, "configs", "000_tiny", "tiny_t2v.yaml")
    cases = [
        ("ddim tiny_t2v", load_configs([tiny]), (4, 64, 64), False),
        ("flow hunyuan narrow", load_configs([CONFIG_HY], _narrow_hunyuan()
                                             + [f"{den}.dtype=float32",
                                                "flow.params.scheduler_config"
                                                ".params.num_steps=3"]),
         (9, 128, 128), False),
        ("int8 tiny_t2v", load_configs([tiny], ["flow.params.ddim_steps=2"]),
         (4, 64, 64), True)]
    for label, cfg, size, int8 in cases:
        cpu, gpu = _narrow_pair(cfg, quantize=int8)
        gen = torch.Generator().manual_seed(3)
        shape = cpu.latent_shape(1, *size)
        prompts = ["a panda playing guitar", "a lake at dawn", "a red kite"]
        uncond = cpu.encode_text([""])
        reqs = [(torch.randn(shape, generator=gen), cpu.encode_text([p]),
                 uncond) for p in prompts]
        on = lambda r, dev: (r[0].to(dev),
                             *({k: v.to(dev) for k, v in d.items()}
                               for d in r[1:]))
        t = cpu.scheduler.timesteps[1].reshape(1)
        calls, got = [], []
        for flow, dev in ((cpu, "cpu"), (gpu, "cuda")):
            zero_counts(A)
            x, c, _ = on(reqs[0], dev)
            with torch.inference_mode(), flow._attn_scope():
                calls.append(flow.denoise_apply(x, t.to(dev), c))
            if int8:
                got.append({0: flow.sample(c, on(reqs[0], dev)[2], shape,
                                           None, 2.0, x_T=x).float().cpu()})
            else:
                got.append(_drive_engine(ContinuousBatchEngine(
                    flow, slots=3, frames=size[0], height=size[1],
                    width=size[2], cfg_scale=2.0),
                    [on(r, dev) for r in reqs]))
            launches = {k: v for k, v in read_counts(A).items() if v}
        errs = {"call": _rel(calls[1], calls[0]),
                **{f"latents_{j}": _rel(got[1][j], got[0][j])
                   for j in got[0]}}
        ok = (sorted(got[0]) == sorted(got[1])
              and all(math.isfinite(e) for e in errs.values())
              and errs["call"] <= REF_VC_TOL_CALL
              and all(e <= REF_VC_TOL_TRAJ for k, e in errs.items()
                      if k != "call"))
        log("reference-serve", case=label, what="engine (or int8 sample), "
            "cuda vs cpu, f32", latent_shape=list(shape), card_launches=launches,
            call_tol=REF_VC_TOL_CALL, latent_tol=REF_VC_TOL_TRAJ,
            **{k: f"{e:.3e}" for k, e in errs.items()}, ok=ok)
        if not ok:
            raise AssertionError(f"reference-serve {label}: the card's "
                                 "engine disagrees with the CPU's")
        del cpu, gpu
        _free()


def _int8_accuracy(den, calls: dict) -> dict:
    """The w8a8 error at full width, before the flow is quantized.  Per
    projection (the gate): during the bf16 denoiser's first call of
    ``calls``, each ``nn.Linear``'s input also goes through its
    ``Int8Linear`` (a hook), and the relative (norm) error of that output
    against the bf16 one is kept: the max, its projection, the mean.  Per
    whole call (reported): for each call of ``calls`` (label → the
    denoiser's inputs), the relative error of a quantized copy against
    the bf16 call, beside the bf16 call's own against an f32 copy (how far
    the random 28-layer model carries rounding)."""
    import copy
    from videotuna_tpu_torch.tools.int8 import Int8Linear, quantize_int8

    def rel(a, b):
        return (torch.linalg.norm(a - b)
                / torch.linalg.norm(b).clamp_min(1e-30)).item()

    def call(m, inputs):
        with torch.inference_mode():
            return m(*inputs)[..., :4].float()

    errs = {}

    def hook(name):
        def fn(mod, args, out):
            errs[name] = rel(Int8Linear(mod)(args[0]).float(), out.float())
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in den.named_modules() if isinstance(m, nn.Linear)]
    try:
        call(den, next(iter(calls.values())))
    finally:
        for h in handles:
            h.remove()
    worst = max(errs, key=errs.get)
    out = {"projections": len(errs), "projection_max_rel_err": errs[worst],
           "projection_max_at": worst,
           "projection_mean_rel_err": sum(errs.values()) / len(errs)}
    q = quantize_int8(copy.deepcopy(den))
    f32 = copy.deepcopy(den).float()
    for m in f32.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    for label, inputs in calls.items():
        ref = call(den, inputs)
        out[f"call_{label}_int8_vs_bf16"] = rel(call(q, inputs), ref)
        out[f"call_{label}_bf16_vs_f32"] = rel(ref, call(f32, inputs))
    del q, f32
    _free()
    y = next(iter(calls.values()))[2].float()
    rms = y.pow(2).mean(-1).sqrt()
    out["caption_peak_to_rms_max"] = (y.abs().amax(-1) / rms)[rms > 0] \
        .max().item()
    return out


def _int_mm_layouts() -> dict:
    """ms of torch._int_mm at the MLP fc1's shape in the 4-slot step (M =
    8 × 4,096 tokens, K = 1,152, N = 4,608) with the int8 weight row-major
    (K, N) and as the transpose of a row-major (N, K) (the layout
    ``Int8Linear`` keeps), beside the bf16 product and the whole
    ``int8_matmul`` (quantise, product, rescale) on bf16 activations."""
    from videotuna_tpu_torch.tools.int8 import int8_matmul
    m, k, n = 2 * SERVE_SLOTS * SERVE_FRAMES * SERVE_TOKENS, 1152, 4608
    gen = torch.Generator("cuda").manual_seed(67)
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w_row = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    w_col = w_row.t().contiguous().t()
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    wb = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
    ws = torch.rand((n,), generator=gen, device="cuda")
    if not torch.equal(torch._int_mm(a, w_row), torch._int_mm(a, w_col)):
        raise AssertionError("torch._int_mm differs between the layouts")
    return {"int_mm_row_major_ms": cuda_time_ms(
                lambda: torch._int_mm(a, w_row), reps=20),
            "int_mm_transposed_ms": cuda_time_ms(
                lambda: torch._int_mm(a, w_col), reps=20),
            "bf16_mm_ms": cuda_time_ms(lambda: x @ wb, reps=20),
            "int8_matmul_ms": cuda_time_ms(
                lambda: int8_matmul(x, w_col, ws), reps=20)}


def run_serve(A) -> tuple:
    """The serving layer on the card at full width: opensorav10_256x256
    .yaml as shipped (STDiT-XL/2: 28 layers, hidden 1152, 16 heads of
    d = 72, bf16; T5-XXL in f32; the 2D KL VAE; DDIM 50 steps, CFG 7.0,
    16×256×256), built once on random weights from the seed, behind each
    service's ThreadingHTTPServer on 127.0.0.1 (an ephemeral port) in this
    process, driven with urllib:

    (a) InferenceService: 2 /generate requests, then /healthz, /metrics;
    (b) BatchingInferenceService(max_batch=4): 4 concurrent requests of
        one geometry, one batched run (batched_with = 4);
    (c) ContinuousBatchingService(slots=4): 6 requests, 2 at once, 2 more
        after 10 engine steps, 2 more after the first finishes; each
        step's seconds by occupancy, each request's time_sec, requests a
        minute; one request's latents against a solo flow.sample of the
        same x_T and prompts (reported: bf16 at another batch);
    then the engine's seconds a step at 1–4 occupied slots and one traced
    4-slot step (busy share), and
    (d) int8: the w8a8 error of each projection at the served call's
        activations (gated at 0.05) and of whole calls at a fresh 4-slot
        engine's first step and later (beside the bf16 call's own error
        against f32; ``_int8_accuracy``); torch._int_mm's layouts; the
        denoiser's bytes before and after quantize_int8 (gated at 0.55×
        of bf16), the quantized flow's call at the 4-slot engine's later
        inputs against the bf16 call kept from before, its seconds a step
        beside bf16's and one traced w8a8 step, then one request through
        InferenceService and one through a one-slot
        ContinuousBatchingService.

    Launches are counted from 0 over (a)–(d)'s requests: 28 K2 and 28 K4
    a denoiser call, all on flash_fwd_sm90.  Returns (its record, the
    window's counts)."""
    from videotuna_tpu_torch.cli.serve import serve
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    from videotuna_tpu_torch.tools.int8 import tree_bytes
    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_configs([CONFIG_OS])
    cfg["inference"]["savedir"] = os.path.join(OUT_DIR, "serve")
    cfg_scale = float(cfg["inference"]["unconditional_guidance_scale"])
    t0 = time.perf_counter()
    flow = instantiate(cfg["flow"], device="cuda")
    flow.init_params(seed=0)
    torch.cuda.synchronize()
    rec = {"build_sec": time.perf_counter() - t0}
    steps = flow.scheduler.num_steps
    per_call = OS_DEPTH
    totals = []

    # (a) one request at a time
    zero_counts(A)
    t0 = time.perf_counter()
    with _serving(serve(cfg, port=0, flow=flow)) as url:
        replies = [_http(url + "/generate", {"prompt": p, "seed": i})
                   for i, p in enumerate(SERVE_PROMPTS[:2])]
        health, metrics = _http(url + "/healthz"), _http(url + "/metrics")
    wall = time.perf_counter() - t0
    _served("serve-a", replies, 2)
    if health[1].get("model") != "OpenSoraFlow" \
            or metrics[1].get("requests_served") != 2:
        raise AssertionError(f"serve-a: healthz {health}, metrics {metrics}")
    totals.append(_serve_window(A, "serve-a", per_call, 2 * steps))
    rec["a"] = dict(time_sec=[r[1]["time_sec"] for r in replies],
                    requests_per_min=2 / wall * 60)
    log("serve-a", service="InferenceService", requests=2,
        time_sec=rec["a"]["time_sec"],
        requests_per_min=f"{rec['a']['requests_per_min']:.3f}",
        healthz=health[1], metrics=metrics[1], launches=totals[-1]["launches"])

    # (b) four concurrent requests coalesced into one batched run
    zero_counts(A)
    t0 = time.perf_counter()
    with _serving(serve(cfg, port=0, max_batch=4, max_wait_ms=2000.0,
                        flow=flow)) as url:
        replies = _posts(url, [{"prompt": p, "seed": 1}
                               for p in SERVE_PROMPTS[:4]])
    wall = time.perf_counter() - t0
    _served("serve-b", replies, 4, batched_with=4)
    totals.append(_serve_window(A, "serve-b", per_call, steps))
    rec["b"] = dict(time_sec=[r[1]["time_sec"] for r in replies],
                    requests_per_min=4 / wall * 60)
    log("serve-b", service="BatchingInferenceService(max_batch=4)",
        requests=4, batched_with=[r[1]["batched_with"] for r in replies],
        time_sec=rec["b"]["time_sec"],
        requests_per_min=f"{rec['b']['requests_per_min']:.3f}",
        launches=totals[-1]["launches"])

    # (c) step-level continuous batching, staggered arrivals
    import threading
    zero_counts(A)
    server = serve(cfg, port=0, continuous_slots=SERVE_SLOTS, flow=flow)
    svc = server.service
    step_log, kept = [], {}
    engine_step, finish = svc.engine.step, svc._finish

    def timed_step():
        n = svc.engine.n_active
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine_step()
        torch.cuda.synchronize()
        step_log.append((n, time.perf_counter() - t1))

    def keep_first(slot, latents):
        if not kept:
            item = svc._slot_items[slot]
            kept.update(prompt=item["prompt"], seed=item["req"]["seed"],
                        latents=latents.clone())
        finish(slot, latents)

    svc.engine.step, svc._finish = timed_step, keep_first
    payloads = [{"prompt": p, "seed": 10 + i}
                for i, p in enumerate(SERVE_PROMPTS)]
    replies = [None] * 6
    t0 = time.perf_counter()
    with _serving(server) as url:
        def post(i):
            replies[i] = _http(url + "/generate", payloads[i])
        threads = []
        for group, ready in (((0, 1), lambda: True),
                             ((2, 3), lambda: len(step_log) >= 10),
                             ((4, 5), lambda: svc.requests_served >= 1)):
            _wait_for(ready, f"the arrival of requests {group}")
            for i in group:
                threads.append(threading.Thread(target=post, args=(i,),
                                                daemon=True))
                threads[-1].start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT)
    wall = time.perf_counter() - t0
    _served("serve-c", replies, 6, continuous=True)
    totals.append(_serve_window(A, "serve-c", per_call, len(step_log)))
    by_occ = {n: [dt for m, dt in step_log if m == n]
              for n in sorted({m for m, _ in step_log})}
    rec["c"] = dict(time_sec=[r[1]["time_sec"] for r in replies],
                    requests_per_min=6 / wall * 60, engine_steps=len(step_log),
                    sec_per_step_by_occupancy={
                        n: sum(v) / len(v) for n, v in by_occ.items()})
    # one request's latents against a solo sample of its x_T and prompts
    x_T = torch.randn(flow.latent_shape(1, SERVE_FRAMES, SERVE_SIZE, SERVE_SIZE),
                      generator=torch.Generator("cuda").manual_seed(
                          kept["seed"]), device="cuda")
    solo = flow.sample(flow.encode_text([kept["prompt"]]),
                       flow.encode_text([""]), x_T.shape, None, cfg_scale,
                       x_T=x_T)
    rec["c"]["solo_max_abs_diff"] = (solo - kept["latents"]).abs().max().item()
    rec["c"]["solo_rel_diff"] = _rel(kept["latents"], solo)
    if not torch.isfinite(kept["latents"]).all():
        raise AssertionError("serve-c: non-finite latents")
    log("serve-c", service=f"ContinuousBatchingService(slots={SERVE_SLOTS})",
        requests=6, engine_steps=len(step_log), time_sec=rec["c"]["time_sec"],
        requests_per_min=f"{rec['c']['requests_per_min']:.3f}",
        sec_per_step_by_occupancy={n: f"{v:.4f}" for n, v in
                                   rec["c"]["sec_per_step_by_occupancy"]
                                   .items()},
        steps_by_occupancy={n: len(v) for n, v in by_occ.items()},
        solo_max_abs_diff=f"{rec['c']['solo_max_abs_diff']:.4e}",
        solo_rel_diff=f"{rec['c']['solo_rel_diff']:.4e}",
        launches=totals[-1]["launches"])

    # the engine alone: seconds a step at 1-4 occupied slots, one traced
    # 4-slot step
    from torch.profiler import ProfilerActivity, profile
    reqs = _engine_requests(flow, SERVE_SLOTS)
    rec["sec_per_step"], eng = _engine_seconds(flow, range(1, 5), reqs,
                                               cfg_scale)
    step_ms = rec["sec_per_step"][4] * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    rec["profile"] = _log_profile("profile-serve", "one 4-slot engine step "
                                  "(STDiT-XL/2 at B = 8)", prof, step_ms,
                                  "flash_fwd (K2+K4)")
    # the bf16 call kept for int8's check: the 4-slot engine's inputs
    # (its slots 6 to 21 steps in), and those of a fresh 4-slot engine's
    # first step (every slot at t = 981)
    def inputs(engine):
        kk = engine.k.clamp(0, steps - 1)
        cc = {k: torch.cat([v, engine.uncond[k]])
              for k, v in engine.cond.items()}
        return (torch.cat([engine.x, engine.x]),
                torch.cat([flow.scheduler.timesteps[steps - 1 - kk]] * 2),
                cc["y"], cc["mask"])

    late = inputs(eng)
    with torch.inference_mode():
        ref = flow.denoise_apply(late[0], late[1], {"y": late[2],
                                                    "mask": late[3]}).float()
    del eng
    _, eng = _engine_seconds(flow, (), reqs, cfg_scale)
    for r in reqs:
        eng.submit(*r)
    first = inputs(eng)
    del eng
    log("serve-engine", slots=SERVE_SLOTS, batch=2 * SERVE_SLOTS,
        sec_per_step={n: f"{v:.4f}" for n, v in rec["sec_per_step"].items()},
        timed_steps=SERVE_TIMED_STEPS)

    # (d) int8: its error at full width and the product's layouts, then
    # the served flow quantized
    acc = _int8_accuracy(flow.denoiser, {"first_step": first,
                                         "later_steps": late})
    log("serve-int8-accuracy", what="w8a8 vs bf16, relative (norm): each "
        "projection at the first step's activations (gated), whole calls "
        "(reported, beside bf16 vs f32)",
        **{k: (f"{v:.4e}" if isinstance(v, float) else v)
           for k, v in acc.items()})
    layouts = _int_mm_layouts()
    log("serve-int8-layouts", shape=f"M{2 * SERVE_SLOTS * SERVE_FRAMES}"
        f"x{SERVE_TOKENS}xK1152xN4608",
        **{k: f"{v:.4f}" for k, v in layouts.items()})
    bf16_bytes = tree_bytes(flow.denoiser)
    flow.quantize_int8()
    int8_bytes = tree_bytes(flow.denoiser)
    with torch.inference_mode():
        out = flow.denoise_apply(late[0], late[1], {"y": late[2],
                                                    "mask": late[3]}).float()
    rel = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
    int8_sec, eng = _engine_seconds(flow, (SERVE_SLOTS,), reqs, cfg_scale)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    rec["int8_profile"] = _log_profile(
        "profile-serve-int8", "one 4-slot w8a8 engine step", prof,
        int8_sec[SERVE_SLOTS] * 1e3, "flash_fwd (K2+K4)",
        extra_groups=(("int8 gemm", ("int_mm", "imma", "igemm", "i8i8",
                                     "s8", "int8")),))
    del eng, out, ref, late, first
    zero_counts(A)
    with _serving(serve(cfg, port=0, flow=flow)) as url:
        replies = [_http(url + "/generate", {"prompt": SERVE_PROMPTS[0],
                                             "seed": 0})]
    # one slot: the scoped engine's w8a8 step at B = 2 (a 4-slot w8a8
    # step takes 0.72 s, timed above)
    with _serving(serve(cfg, port=0, continuous_slots=1,
                        flow=flow)) as url:
        replies.append(_http(url + "/generate", {"prompt": SERVE_PROMPTS[1],
                                                 "seed": 1}))
    _served("serve-int8", replies[:1], 1)
    _served("serve-int8", replies[1:], 1, continuous=True)
    totals.append(_serve_window(A, "serve-int8", per_call, 2 * steps))
    rec["int8"] = dict(accuracy=acc, layouts=layouts,
                       bf16_bytes=bf16_bytes, int8_bytes=int8_bytes,
                       bytes_ratio=int8_bytes / bf16_bytes, rel_err=rel,
                       sec_per_step=int8_sec[SERVE_SLOTS],
                       bf16_sec_per_step=rec["sec_per_step"][SERVE_SLOTS],
                       time_sec=[r[1]["time_sec"] for r in replies])
    ok = (int8_bytes <= INT8_BYTES_GATE * bf16_bytes and math.isfinite(rel)
          and acc["projection_max_rel_err"] <= INT8_REL_GATE)
    log("serve-int8", denoiser_bf16_bytes=bf16_bytes,
        denoiser_int8_bytes=int8_bytes,
        bytes_ratio=f"{int8_bytes / bf16_bytes:.4f}",
        bytes_gate=INT8_BYTES_GATE, call_rel_err=f"{rel:.4e}",
        projection_max_rel_err=f"{acc['projection_max_rel_err']:.4e}",
        rel_gate=INT8_REL_GATE,
        sec_per_step=f"{rec['int8']['sec_per_step']:.4f}",
        bf16_sec_per_step=f"{rec['int8']['bf16_sec_per_step']:.4f}",
        time_sec=rec["int8"]["time_sec"], launches=totals[-1]["launches"],
        ok=ok)
    if not ok:
        raise AssertionError("serve-int8: the int8 denoiser's bytes or a "
                             "projection's w8a8 error is above its gate")
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("serve", peak_mem_gb=f"{rec['peak_gb']:.2f}",
        launches_per_request=per_call * steps,
        launches_per_engine_step=per_call)
    del flow
    _free()
    window = {key: {k: sum(t[key][k] for t in totals)
                    for k in totals[0][key]} for key in ("launches", "sm90")}
    return rec, window


def run_serving(A) -> tuple:
    """The serving phases in order (K-serve, reference-serve, serve):
    (K-serve's records, the served run's record, its launch counts)."""
    kserve = timed_phase("K-serve", check_k_serve, A)
    check_small_reference_serve(A)
    rec, window = timed_phase("serve", run_serve, A)
    return kserve, rec, window


# ---------------------------------------------------------------- phases 69-72
# the ring's hops at full width: HunyuanVideo 13B's self-attention at
# 129×720×1280 (33·45·80 video + 256 text tokens) over P = 4 sequence
# blocks of 29,764; the backward at the HunyuanVideo LoRA run's 7,456
RING_P = 4
RING_FWD_S = SHAPE_HY["s"]
RING_BWD_S = HY_TRAIN_TOKENS
# the collective path: Wan 2.1 1.3B's self-attention (B=2 under CFG,
# 21·30·52 = 32,760 tokens, 12 heads of d = 128) through sp_attention on
# threaded ranks of this process on the one card
SHAPE_SP = dict(b=2, s=SHAPE_WAN13["s"], h=12)
SP_MODES = {   # label: (mesh axes, Ulysses axis, ring axis)
    "ulysses P=2": ({"sp": 2}, "sp", None),
    "ring P=2": ({"sp": 2}, None, "sp"),
    "ulysses P=4": ({"sp": 4}, "sp", None),
    "ring P=4": ({"sp": 4}, None, "sp"),
    "hybrid 2x2": ({"sp": 2, "tp": 2}, "sp", "tp"),
}
# the narrow checks at P = 2 against P = 1 on the card, f32, TF32 off
PAR_TOL_CALL = 1e-4
PAR_TOL_TRAJ = 1e-3
PAR_MIN_SEQ = 128            # the narrow flows' sequences are short
# the narrow Wan training steps at P > 1: label → (mesh axes, batch)
PAR_TRAIN = {"fsdp2": ({"fsdp": 2}, 2), "sp2": ({"sp": 2}, 2),
             "fsdp2_sp2": ({"fsdp": 2, "sp": 2}, 4)}
# their gates against P = 1 (bf16, the online softmax on both sides):
# label → (loss and gradient norm, relative; a gradient, of its max).
# Ulysses only moves heads, so sp 2's forward is P = 1's and its
# gradients differ by dq's f32 atomic adds rounded to bf16; FSDP2 reduces
# bf16 gradients of half the batch, about 2 bf16 ulps of a leaf's max
# (7.3e-3 on the card before these gates).  A rank that attends another
# rank's samples is off by O(1).
PAR_TRAIN_TOL = {"fsdp2": (5e-4, 2e-2), "sp2": (1e-4, 1e-2),
                 "fsdp2_sp2": (5e-4, 2e-2)}


def _torch_ranks():
    """``tests/torch_ranks.py`` of this checkout (the threaded ranks), by
    its path: an installed package named ``tests`` would shadow it."""
    import importlib.util
    if "torch_ranks" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "torch_ranks", os.path.join(ROOT, "tests", "torch_ranks.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules["torch_ranks"] = module
        spec.loader.exec_module(module)
    return sys.modules["torch_ranks"]


def _hop_blocks(x, p):
    n = x.shape[1] // p
    return [x[:, i * n:(i + 1) * n].contiguous() for i in range(p)]


def _cudnn_lse_ms(q, k, v, scale, reps):
    """cuDNN attention writing the LSE on the same tensors ((B, H, S, D)
    copies), a yardstick only; flash-attention's op where cuDNN does not
    take them.  (ms by events, device ms, the op's name)."""
    from videotuna_tpu_torch.kernels.attribution import device_ms
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ops = (("cudnn", lambda: torch.ops.aten._scaled_dot_product_cudnn_attention(
                qt, kt, vt, None, True, 0.0, False, False, scale=scale)),
           ("flash", lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, False, False, scale=scale)))
    for name, call in ops:
        try:
            call()
            torch.cuda.synchronize()
            return cuda_time_ms(call, reps), device_ms(call, reps), name
        except (RuntimeError, TypeError) as e:
            log("K-ring", library=name, unavailable=str(e)[:80])
    return None, None, None


def check_ring_hops(A) -> dict:
    """The ring's hop functions at full width, without collectives: P = 4
    query blocks of HunyuanVideo's 119,056 tokens each attended to the 4
    key/value blocks by ``_hop_attention`` (K5, online with the LSE, on
    K3's kernel at d = 128: 16 launches) and merged by ``merge_hop``,
    against one unsharded online call (K2 on K3's kernel) and the
    unsharded LSE (K5); one hop against its plain version.  The backward
    at the LoRA shape (7,456 tokens): 16 ``_hop_backward`` launches (K8 on
    flash_bwd_sm90 at d = 128, each with the global output and LSE over
    one key block), dq, dk and dv summed over the hops, against one
    unsharded K8 call; one hop against its plain version.  Each hop timed
    by events and by device time (a CUDA graph's replay) beside its bound
    (the forward's with the exp2 floor), the plain version and cuDNN (the
    forward writing the LSE; SDPA's backward), each ring beside its
    unsharded call."""
    from videotuna_tpu_torch.parallel import sequence as PS
    gen = torch.Generator(device="cuda").manual_seed(23)
    b, h, d, p = 1, SHAPE_HY["h"], 128, RING_P
    sm = d ** -0.5
    recs = {}

    def qkv(s):
        q, k = (_rms(torch.randn((b, s, h, d), generator=gen,
                                 device="cuda")).bfloat16()
                for _ in range(2))
        return q, k, torch.randn((b, s, h, d), generator=gen,
                                 device="cuda").bfloat16()

    # ---- forward
    q, k, v = qkv(RING_FWD_S)
    qs, ks, vs = (_hop_blocks(x, p) for x in (q, k, v))
    n = qs[0].shape[1]

    def ring():
        outs, lses = [], []
        for qi in qs:
            acc = run = None
            for kj, vj in zip(ks, vs):
                acc, run = PS.merge_hop(acc, run,
                                        *PS._hop_attention(qi, kj, vj, sm))
            outs.append(acc.to(q.dtype))
            lses.append(run)
        return torch.cat(outs, dim=1), torch.cat(lses, dim=1)

    before = (A.flash_fwd.launches["K5"], A.flash_fwd.launches_d128["K5"])
    out, lse = ring()
    hops = A.flash_fwd.launches["K5"] - before[0]
    on_d128 = A.flash_fwd.launches_d128["K5"] - before[1]
    ref = A.flash_fwd(q, k, v, sm_scale=sm, route="K2")
    _, ref_lse = A.flash_fwd(q, k, v, sm_scale=sm, emit_lse=True, route="K5")
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = FWD_TOL * ref.float().abs().max().item()
    lse_err = (lse - ref_lse.transpose(1, 2)).abs().max().item()
    del ref, ref_lse, out, lse
    # one hop against its plain version, the query block 0 on key block 1
    o_h, lse_h = PS._hop_attention(qs[0], ks[1], vs[1], sm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_h, ref_lse_h = _plain_chunked(A, qs[0], ks[1], vs[1], None)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hop_err = (o_h - ref_h.float()).abs().max().item()
    hop_tol = FWD_TOL * ref_h.float().abs().max().item()
    hop_lse_err = (lse_h - ref_lse_h.transpose(1, 2)).abs().max().item()
    del o_h, lse_h, ref_h, ref_lse_h
    ok = (hops == on_d128 == p * p and err <= tol and lse_err <= LSE_TOL
          and hop_err <= hop_tol and hop_lse_err <= LSE_TOL)
    from videotuna_tpu_torch.kernels.attribution import device_ms
    ms = cuda_time_ms(lambda: PS._hop_attention(qs[0], ks[1], vs[1], sm),
                      reps=5)
    dev_ms = device_ms(lambda: PS._hop_attention(qs[0], ks[1], vs[1], sm),
                       reps=3)
    ring_ms = cuda_time_ms(ring, reps=2)
    whole_ms = cuda_time_ms(lambda: A.flash_fwd(
        q, k, v, sm_scale=sm, emit_lse=True, route="K5"), reps=3)
    library_ms, library_dev_ms, library = _cudnn_lse_ms(
        qs[0], ks[1], vs[1], sm, reps=3)
    flops = 4.0 * b * h * n * n * d
    bound_ms, bound_by = _bound(flops, 4 * qs[0].numel() * 2 + b * h * n * 4,
                                _exp2_floor_ms(h * n * n))
    recs["K5 ring hop"] = dict(
        max_abs_err=hop_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, lse_err=hop_lse_err,
        device_ms=dev_ms, library_device_ms=library_dev_ms,
        ring_ms=ring_ms, unsharded_ms=whole_ms, ring_max_abs_err=err,
        ring_lse_err=lse_err, hops=hops)
    log("K-ring", case="HunyuanVideo 13B 129x720x1280 self-attention, "
        f"P={p} ring hops, no collectives",
        shape=f"B{b}xS{RING_FWD_S}xH{h}xd{d}, hop {n}x{n}",
        kernel="flash_fwd_sm90 (K3's kernel, online, with the LSE)",
        hop_launches=hops, on_d128=on_d128,
        ring_max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
        ring_lse_err=f"{lse_err:.3e}", lse_tol=LSE_TOL,
        hop_max_abs_err=f"{hop_err:.3e}", hop_tol=f"{hop_tol:.3e}",
        hop_lse_err=f"{hop_lse_err:.3e}",
        hop_ms=f"{ms:.3f}", hop_tflops=f"{flops / ms / 1e9:.1f}",
        hop_device_ms=f"{dev_ms:.3f}",
        bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        plain_ms=f"{plain_ms:.1f}", library=f"{library} with the LSE",
        library_ms=(f"{library_ms:.3f}" if library_ms else None),
        library_device_ms=(f"{library_dev_ms:.3f}" if library_dev_ms
                           else None),
        ring_ms=f"{ring_ms:.2f}", unsharded_k5_ms=f"{whole_ms:.2f}",
        ring_over_unsharded=f"{ring_ms / whole_ms:.3f}", ok=ok)
    if not ok:
        raise AssertionError("the ring's K5 hops disagree with the "
                             "unsharded call or their plain version")
    del q, k, v, qs, ks, vs
    _free()

    # ---- backward
    q, k, v = qkv(RING_BWD_S)
    g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    out, lse = A.flash_fwd(q, k, v, sm_scale=sm, emit_lse=True, route="K5")
    qs, ks, vs, os_, gs = (_hop_blocks(x, p) for x in (q, k, v, out, g))
    n = qs[0].shape[1]
    lses = [lse[:, :, i * n:(i + 1) * n].contiguous() for i in range(p)]
    before = (A.flash_bwd.launches["K8"], A.flash_bwd.launches_d128["K8"])

    def ring_bwd():
        dq = [torch.zeros(x.shape, dtype=torch.float32, device="cuda")
              for x in qs]
        dk = [torch.zeros_like(x) for x in dq]
        dv = [torch.zeros_like(x) for x in dq]
        for i in range(p):
            for j in range(p):
                a, bb, c = PS._hop_backward(qs[i], ks[j], vs[j], os_[i],
                                            lses[i], gs[i], sm)
                dq[i] += a.float()
                dk[j] += bb.float()
                dv[j] += c.float()
        return [torch.cat(x, dim=1) for x in (dq, dk, dv)]

    got = ring_bwd()
    hops = A.flash_bwd.launches["K8"] - before[0]
    on_d128 = A.flash_bwd.launches_d128["K8"] - before[1]
    ref = A.flash_bwd(q, k, v, out, g, lse, sm_scale=sm)
    torch.cuda.synchronize()
    err, ring_ok, rows = _bwd_errs(got, ref)
    del got, ref

    def hop():
        return PS._hop_backward(qs[0], ks[1], vs[1], os_[0], lses[0], gs[0],
                                sm)

    h_got = hop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_ref = _bwd_plain_chunked(A, qs[0], ks[1], vs[1], os_[0], gs[0],
                               lses[0], sm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hop_err, hop_ok, hop_rows = _bwd_errs(h_got, h_ref)
    del h_got, h_ref
    ok = hops == on_d128 == p * p and ring_ok and hop_ok
    ms = cuda_time_ms(hop, reps=5)
    dev_ms = device_ms(hop, reps=5)
    library_dev_ms = sdpa_bwd_device_ms(qs[0], ks[1], vs[1], gs[0],
                                        reps=3)[0]
    ring_ms = cuda_time_ms(ring_bwd, reps=3)
    whole_ms = cuda_time_ms(lambda: A.flash_bwd(q, k, v, out, g, lse,
                                                sm_scale=sm), reps=3)
    library_ms, backend = sdpa_bwd_ms(qs[0], ks[1], vs[1], gs[0], reps=5)
    flops = 10.0 * b * h * n * n * d
    bound_ms, bound_by = _bound(flops, 8 * qs[0].numel() * 2 + b * h * n * 4)
    recs["K8 ring hop"] = dict(
        max_abs_err=hop_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, ring_max_abs_err=err,
        device_ms=dev_ms, library_device_ms=library_dev_ms,
        ring_ms=ring_ms, unsharded_ms=whole_ms, hops=hops)
    log("K-ring", case="HunyuanVideo LoRA shape, P=4 ring backward hops "
        "with the global output and LSE, no collectives",
        shape=f"B{b}xS{RING_BWD_S}xH{h}xd{d}, hop {n}x{n}",
        kernel="flash_bwd_sm90 d=128", hop_launches=hops, on_d128=on_d128,
        ring_dq=rows[0], ring_dk=rows[1], ring_dv=rows[2],
        hop_dq=hop_rows[0], hop_dk=hop_rows[1], hop_dv=hop_rows[2],
        hop_ms=f"{ms:.3f}", hop_tflops=f"{flops / ms / 1e9:.1f}",
        hop_device_ms=f"{dev_ms:.4f}",
        bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        plain_ms=f"{plain_ms:.1f}", library=f"sdpa backward[{backend}]",
        library_ms=f"{library_ms:.3f}",
        library_device_ms=f"{library_dev_ms:.4f}", ring_ms=f"{ring_ms:.3f}",
        unsharded_k8_ms=f"{whole_ms:.3f}",
        ring_over_unsharded=f"{ring_ms / whole_ms:.3f}", ok=ok)
    if not ok:
        raise AssertionError("the ring's K8 hops disagree with the "
                             "unsharded backward or their plain version")
    del q, k, v, g, out, lse, qs, ks, vs, os_, gs, lses
    _free()
    return recs


def _sp_inputs():
    gen = torch.Generator(device="cuda").manual_seed(29)
    shape = (SHAPE_SP["b"], SHAPE_SP["s"], SHAPE_SP["h"], 128)
    q, k = (_rms(torch.randn(shape, generator=gen, device="cuda")).bfloat16()
            for _ in range(2))
    return q, k, torch.randn(shape, generator=gen, device="cuda").bfloat16()


def check_ulysses_local(A) -> dict:
    """The Ulysses local call at Wan 1.3B's shape on H/P = 6 heads (P = 2):
    ``flash_attention_diff``'s forward (K5 with the LSE on K3's kernel at
    d = 128) against its plain version, and its backward (K8 on
    flash_bwd_sm90), each timed by events and device time beside its
    bound, the plain version and cuDNN (with the LSE; SDPA's backward)."""
    q, k, v = (x[:, :, :SHAPE_SP["h"] // 2].contiguous()
               for x in _sp_inputs())
    b, s, h, d = q.shape
    sm = d ** -0.5

    def fwd():
        return A.flash_fwd(q, k, v, sm_scale=sm, emit_lse=True, route="K5")

    out, lse = fwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_lse = _plain_chunked(A, q, k, v, None, rows=512)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out.float() - ref.float()).abs().max().item()
    tol = FWD_TOL * ref.float().abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del ref, ref_lse
    from videotuna_tpu_torch.kernels.attribution import device_ms
    ms = cuda_time_ms(fwd, reps=5)
    dev_ms = device_ms(fwd, reps=3)
    library_ms, library_dev_ms, library = _cudnn_lse_ms(q, k, v, sm, reps=3)
    flops = 4.0 * b * h * s * s * d
    bound_ms, bound_by = _bound(flops, 4 * q.numel() * 2 + b * h * s * 4,
                                _exp2_floor_ms(b * h * s * s))
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(31)
                    ).bfloat16()

    def bwd():
        return A.flash_bwd(q, k, v, out, g, lse, sm_scale=sm)

    got = bwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bref = _bwd_plain_chunked(A, q, k, v, out, g, lse, sm, rows=512)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t0) * 1e3
    bwd_err, bwd_ok, rows = _bwd_errs(got, bref)
    del got, bref
    bwd_ms = cuda_time_ms(bwd, reps=5)
    bwd_dev_ms = device_ms(bwd, reps=3)
    bwd_library_ms, backend = sdpa_bwd_ms(q, k, v, g, reps=5)
    bwd_library_dev_ms = sdpa_bwd_device_ms(q, k, v, g, reps=3)[0]
    bwd_flops = 10.0 * b * h * s * s * d
    bwd_bound_ms, bwd_bound_by = _bound(bwd_flops, 8 * q.numel() * 2
                                        + b * h * s * 4)
    ok = err <= tol and lse_err <= LSE_TOL and bwd_ok
    log("K-ulysses", case="Wan 2.1 1.3B self-attention, the Ulysses local "
        "call at P=2 (H/P = 6 heads)", shape=f"B{b}xS{s}xH{h}xd{d}",
        kernel="flash_fwd_sm90 (K3's kernel, online, LSE) + flash_bwd_sm90",
        max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
        lse_err=f"{lse_err:.3e}", ms=f"{ms:.3f}",
        device_ms=f"{dev_ms:.3f}",
        tflops=f"{flops / ms / 1e9:.1f}", bound_ms=f"{bound_ms:.3f}",
        bound_by=bound_by, plain_ms=f"{plain_ms:.1f}",
        library=f"{library} with the LSE",
        library_ms=(f"{library_ms:.3f}" if library_ms else None),
        library_device_ms=(f"{library_dev_ms:.3f}" if library_dev_ms
                           else None),
        bwd=",".join(rows), bwd_ms=f"{bwd_ms:.3f}",
        bwd_device_ms=f"{bwd_dev_ms:.3f}",
        bwd_tflops=f"{bwd_flops / bwd_ms / 1e9:.1f}",
        bwd_bound_ms=f"{bwd_bound_ms:.3f}",
        bwd_plain_ms=f"{bwd_plain_ms:.1f}",
        bwd_library=f"sdpa backward[{backend}]",
        bwd_library_ms=f"{bwd_library_ms:.3f}",
        bwd_library_device_ms=f"{bwd_library_dev_ms:.3f}", ok=ok)
    if not ok:
        raise AssertionError("the Ulysses local call disagrees with its "
                             "plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, lse_err=lse_err,
                device_ms=dev_ms, library_device_ms=library_dev_ms,
                bwd_max_abs_err=bwd_err, bwd_ms=bwd_ms,
                bwd_device_ms=bwd_dev_ms, bwd_plain_ms=bwd_plain_ms,
                bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by,
                bwd_library_ms=bwd_library_ms,
                bwd_library_device_ms=bwd_library_dev_ms)


def run_sp_collective(A) -> dict:
    """The collective path on the one card: ``sp_attention`` forward and
    backward (the gradients of Σ out²) at Wan 1.3B's shape through
    Ulysses and the ring at P = 2 and 4 and the 2×2 hybrid, the ranks
    threads of this process over a threaded process group
    (``tests/torch_ranks.py``), every rank's global output and gradients
    against the unsharded differentiable call (K5 + K8) within 2e-2 of
    their max.  The counts are set to 0 just before these runs and read
    just after: the ring's K5 and K8 hops (P² a ring, 2 a hybrid rank),
    the Ulysses local calls' (P each way), all on the Hopper designs at
    d = 128."""
    run_threaded = _torch_ranks().run_threaded
    sp_attention_rank = _torch_ranks().sp_attention_rank
    q, k, v = _sp_inputs()
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out = A.flash_attention_diff(qq, kk, vv)
    (out.float() ** 2).sum().backward()
    ref = [out.detach(), qq.grad, kk.grad, vv.grad]
    tols = [FWD_TOL * ref[0].float().abs().max().item()] + [
        BWD_TOL * r.float().abs().max().item() for r in ref[1:]]
    del qq, kk, vv, out
    zero_counts(A)
    walls = {}
    # the launch-site counts of each mode's run: a ring's or hybrid's are
    # its hops, a Ulysses run's its local calls
    hops = {"K5": 0, "K8": 0}
    for label, (axes, u, r) in SP_MODES.items():
        world = math.prod(axes.values())
        before = read_counts(A)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_threaded(world, sp_attention_rank, axes, u, r, q, k, v,
                           ("dp", "fsdp"), "cuda")
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - t0) * 1e3
        if r is not None:
            after = read_counts(A)
            for key in hops:
                hops[key] += after[key] - before[key]
        errs = [max((x.float() - y.float()).abs().max().item()
                    for x in (rank[i] for rank in res)) for i, y in
                enumerate(ref)]
        ok = all(e <= t for e, t in zip(errs, tols))
        log("sp-collective", mode=label, ranks=world,
            shape=f"B{SHAPE_SP['b']}xS{SHAPE_SP['s']}xH{SHAPE_SP['h']}xd128",
            out_err=f"{errs[0]:.3e}/{tols[0]:.3e}",
            dq=f"{errs[1]:.3e}/{tols[1]:.3e}",
            dk=f"{errs[2]:.3e}/{tols[2]:.3e}",
            dv=f"{errs[3]:.3e}/{tols[3]:.3e}",
            wall_ms=f"{walls[label]:.1f}", ok=ok)
        if not ok:
            raise AssertionError(f"sp_attention {label} disagrees with the "
                                 "unsharded call")
        del res
    counts, sm90 = read_counts(A), read_sm90_counts(A)
    ring = sum(math.prod(a.values()) ** 2 for lab, (a, u, r)
               in SP_MODES.items() if u is None)
    ring += sum(math.prod(a.values()) * a["tp"] for lab, (a, u, r)
                in SP_MODES.items() if u and r)
    ulysses = sum(math.prod(a.values()) for lab, (a, u, r)
                  in SP_MODES.items() if r is None)
    expected = {"K5": ring + ulysses, "K8": ring + ulysses}
    got = {key: n for key, n in counts.items() if n}
    ok = (got == expected and hops["K5"] == hops["K8"] == ring
          and sm90["K5_d128"] == sm90["K5"] == expected["K5"]
          and sm90["K8_d128"] == sm90["K8"] == expected["K8"])
    log("sp-collective", launches=got, hop_launches=hops,
        expected=dict(expected, ring_hops=ring, ulysses_local=ulysses),
        ok=ok)
    if not ok:
        raise AssertionError("the collective path's launches are not the "
                             "ring's hops and the Ulysses local calls on "
                             "the Hopper designs at d = 128")
    del q, k, v, ref
    _free()
    return dict(hops_k5=hops["K5"], hops_k8=hops["K8"],
                ulysses_k5=counts["K5"] - hops["K5"],
                ulysses_k8=counts["K8"] - hops["K8"],
                wall_ms=walls)


def _rel_close(got, ref, tol):
    """(max|got − ref| / max|ref|, whether it is finite and within tol)."""
    err = ((got.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    return err, math.isfinite(err) and err <= tol


def _hy_rank(rank, flows, x_T, t, prompt, world):
    """One rank of the narrow HunyuanVideo flow under ``use_mesh`` and
    ``sequence_parallel`` over sp = ``world``: (a denoiser call, the
    sampled latents)."""
    from videotuna_tpu_torch.core.mesh import MeshConfig, make_mesh, use_mesh
    from videotuna_tpu_torch.kernels.attention import sequence_parallel
    flow = flows[rank]
    mesh = make_mesh(MeshConfig(sp=world), "cuda")
    with use_mesh(mesh), sequence_parallel(mesh, min_seq=PAR_MIN_SEQ):
        cond = flow.encode_text([prompt])
        with torch.inference_mode(), flow._attn_scope():
            call = flow.denoise_apply(x_T, t, cond)
        z = flow.sample(cond, None, x_T.shape, None, 1.0, x_T=x_T)
    return call.float().cpu(), z.float().cpu()


def _step_rank(rank, flows, x, t, cond, world):
    """One rank of the narrow StepVideo flow's denoiser call after
    ``shard_for_tp`` over tp = ``world`` (none at 1)."""
    from videotuna_tpu_torch.core.mesh import MeshConfig, make_mesh
    flow = flows[rank]
    if world > 1:
        flow.shard_for_tp(make_mesh(MeshConfig(tp=world), "cuda"))
    with torch.inference_mode():
        return flow.denoise_apply(x, t, cond).float().cpu()


@tf32_off()
def check_parallel_reference(A) -> None:
    """At P = 2 against P = 1 on the card, f32, TF32 off, the ranks threads
    over the threaded group: (a) the narrow HunyuanVideo flow (dim 256, 2
    heads of d = 128) under ``use_mesh`` and ``sequence_parallel``
    (Ulysses, min_seq 128: the 352 joint tokens split): one denoiser call
    and the latents after 2 steps, 1e-4 and 1e-3 of max; (b) one narrow
    Wan training step (dim 256, 2 layers) at {fsdp: 2} (FSDP2 over the
    threaded group), at {sp: 2} and at {fsdp: 2, sp: 2} (four ranks, a
    batch of 4: each fsdp rank's block of 2 shared by its sp ranks): the
    loss, the gradient norm and every weight's gradient, in bf16 (the
    card's backward kernels take bf16 only), every attention call on the
    online softmax on both sides, within ``PAR_TRAIN_TOL``; (c) the narrow StepVideo flow's denoiser call at {tp: 2}
    (DTensor column/row sharding), 1e-4 of max."""
    from videotuna_tpu_torch.core.config import load_configs
    from videotuna_tpu_torch.core.registry import instantiate
    # (a) HunyuanVideo sampling under SP
    den = "flow.params.denoiser_config.params"
    cfg = load_configs([CONFIG_HY], _narrow_hunyuan() + [
        f"{den}.dtype=float32",
        f"flow.params.scheduler_config.params.num_steps={HY_REF_STEPS}"])
    flows = []
    for _ in range(3):
        f = instantiate(cfg["flow"], device="cuda")
        f.init_params(seed=1)
        flows.append(f)
    shape = flows[0].latent_shape(1, 9, 128, 128)
    x_T = torch.randn(shape, generator=torch.Generator().manual_seed(2)
                      ).cuda()
    t = flows[0].scheduler.timesteps[1].reshape(1).cuda()
    prompt = "a panda playing guitar by a lake"
    run_threaded = _torch_ranks().run_threaded
    train_step_rank = _torch_ranks().train_step_rank
    single = _hy_rank(0, flows[2:], x_T, t, prompt, 1)
    zero_counts(A)
    pair = run_threaded(2, _hy_rank, flows[:2], x_T, t, prompt, 2)
    launches = {k: n for k, n in read_counts(A).items() if n}
    rows = []
    for rank, (call, z) in enumerate(pair):
        e_call, ok_call = _rel_close(call, single[0], PAR_TOL_CALL)
        e_z, ok_z = _rel_close(z, single[1], PAR_TOL_TRAJ)
        rows.append((e_call, e_z, ok_call and ok_z))
    ok = all(r[2] for r in rows)
    log("reference-parallel", what="narrow HunyuanVideo, sp=2 vs P=1, "
        "f32", latent_shape=list(shape), card_launches=launches,
        call_rel_err=",".join(f"{r[0]:.3e}" for r in rows),
        call_tol=PAR_TOL_CALL,
        latent_rel_err=",".join(f"{r[1]:.3e}" for r in rows),
        latent_tol=PAR_TOL_TRAJ, ok=ok)
    if not ok:
        raise AssertionError("reference-parallel: HunyuanVideo at sp=2 "
                             "disagrees with P=1")
    del flows, pair
    _free()

    # (b) one Wan training step at {fsdp: 2}, {sp: 2} and {fsdp: 2, sp: 2}
    cfg = load_configs([CONFIG_WAN13], _narrow_wan())
    workdir = os.path.join(OUT_DIR, "parallel_train")

    def inputs(n):
        gen = torch.Generator().manual_seed(4)
        return ({"latents": torch.randn((n, 3, 16, 16, 16), generator=gen),
                 "text_states": torch.randn((n, 32, 64), generator=gen)},
                {"sigma": torch.rand((n,), generator=gen),
                 "noise": torch.randn((n, 3, 16, 16, 16), generator=gen)})

    def wan_flows(n):
        out = []
        for _ in range(n):
            f = instantiate(cfg["flow"], device="cuda")
            f.init_params(seed=1)
            # every call on the online softmax, which the routed SP calls
            # run: both sides compute one function
            f.attn_static_max = None
            out.append(f)
        return out

    refs = {}
    for label, (axes, n) in PAR_TRAIN.items():
        batch, draws = inputs(n)
        if n not in refs:
            refs[n] = train_step_rank(0, {}, wan_flows(1), batch, draws,
                                      workdir, "cuda")
        ref = refs[n]
        world = math.prod(axes.values())
        res = run_threaded(world, train_step_rank, axes, wan_flows(world),
                           batch, draws, workdir, "cuda",
                           PAR_MIN_SEQ if "sp" in axes else None)
        loss_tol, grad_tol = PAR_TRAIN_TOL[label]
        worst, worst_loss, ok = 0.0, 0.0, True
        for loss, gnorm, grads, n_sharded in res:
            worst_loss = max(worst_loss, abs(loss - ref[0]) / abs(ref[0]),
                             abs(gnorm - ref[1]) / ref[1])
            for name, r in ref[2].items():
                e, good = _rel_close(grads[name], r, grad_tol)
                worst = max(worst, e)
                ok = ok and good
            ok = ok and (n_sharded > 0) == ("fsdp" in axes)
        ok = ok and worst_loss <= loss_tol
        log("reference-parallel", what=f"narrow Wan training step {axes}, "
            f"batch {n}, vs P=1, bf16, online softmax on both",
            loss=f"{res[0][0]:.6f}", ref_loss=f"{ref[0]:.6f}",
            grad_norm=f"{res[0][1]:.6f}", ref_grad_norm=f"{ref[1]:.6f}",
            sharded_weights=res[0][3],
            worst_loss_rel_err=f"{worst_loss:.3e}",
            worst_grad_rel_err=f"{worst:.3e}", loss_tol=loss_tol,
            grad_tol=grad_tol, ok=ok)
        if not ok:
            raise AssertionError(f"reference-parallel: the Wan step at "
                                 f"{axes} disagrees with P=1")
    _free()

    # (c) StepVideo's denoiser at {tp: 2}
    sd = "flow.params.denoiser_config.params"
    cfg = load_configs([CONFIG_STEP], [
        f"{sd}.dim=256", f"{sd}.heads=2", f"{sd}.num_layers=2",
        f"{sd}.ffn_dim=512", f"{sd}.text_dim=256", f"{sd}.clip_dim=32",
        f"{sd}.dtype=float32", f"{sd}.scan_blocks=false",
        "flow.params.cond_stage_config.params.dim=256",
        "flow.params.cond_stage_config.params.heads=2",
        "flow.params.cond_stage_config.params.groups=1",
        "flow.params.cond_stage_config.params.num_layers=1",
        "flow.params.cond_stage_config.params.vocab_size=32768",
        "flow.params.cond_stage_2_config.params.dim=32",
        "flow.params.cond_stage_2_config.params.heads=2",
        "flow.params.cond_stage_2_config.params.num_layers=1",
        "flow.params.first_stage_config.params.ch=32",
        "flow.params.first_stage_config.params.num_res_blocks=1"])
    flows = []
    for _ in range(3):
        f = instantiate(cfg["flow"], device="cuda")
        f.init_params(seed=1)
        flows.append(f)
    gen = torch.Generator().manual_seed(5)
    mask = torch.ones((2, 24), dtype=torch.bool)
    mask[1, 9:] = False
    x = torch.randn((2, 2, 8, 8, 64), generator=gen).cuda()
    tt = torch.tensor([500.0, 500.0], device="cuda")
    cond = {"y": torch.randn((2, 24, 256), generator=gen).cuda(),
            "y2": torch.randn((2, 77, 32), generator=gen).cuda(),
            "y_mask": mask.cuda()}
    single = _step_rank(0, flows[2:], x, tt, cond, 1)
    res = run_threaded(2, _step_rank, flows[:2], x, tt, cond, 2)
    errs = [_rel_close(o, single, PAR_TOL_CALL) for o in res]
    ok = all(good for _, good in errs)
    log("reference-parallel", what="narrow StepVideo denoiser call, tp=2 "
        "vs P=1, f32", rel_err=",".join(f"{e:.3e}" for e, _ in errs),
        tol=PAR_TOL_CALL, ok=ok)
    if not ok:
        raise AssertionError("reference-parallel: StepVideo at tp=2 "
                             "disagrees with P=1")
    del flows
    _free()


def run_sp_torchrun() -> dict:
    """On a machine with two or more cards: ``python -m
    torch.distributed.run`` starts one NCCL rank a card, each running
    Ulysses and the ring at P = the card count on Wan 1.3B's shape
    (``--parallel-rank``); rank 0 prints what they gave.  With one card it
    does not run (NCCL takes one rank a device), and says so."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log("sp-torchrun", ran=False, cards=cards,
            reason="one card: NCCL takes one rank a device; the collective "
                   "path ran on threaded ranks (sp-collective)")
        return {"ran": False, "cards": cards}
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={cards}", os.path.join(ROOT, "chip_smoke.py"),
         "--parallel-rank"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
    log("sp-torchrun", cards=cards, rc=res.returncode,
        result=lines[-1] if lines else None, stderr=res.stderr[-800:])
    if res.returncode != 0 or not lines:
        raise AssertionError("the torchrun ranks failed")
    return dict(json.loads(lines[-1]), ran=True, cards=cards)


def parallel_rank() -> None:
    """One torchrun rank of ``run_sp_torchrun``: Ulysses and the ring over
    every card, against the unsharded call on rank 0's card."""
    import torch.distributed as dist
    from videotuna_tpu_torch.core.mesh import initialize_distributed
    import videotuna_tpu_torch.kernels.attention as A
    initialize_distributed("cuda")
    world = dist.get_world_size()
    q, k, v = _sp_inputs()
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out = A.flash_attention_diff(qq, kk, vv)
    (out.float() ** 2).sum().backward()
    ref = [out.detach(), qq.grad, kk.grad, vv.grad]
    rec = {}
    for label, u, r in (("ulysses", "sp", None), ("ring", None, "sp")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = _torch_ranks().sp_attention_rank(
            dist.get_rank(), {"sp": world}, u, r, q, k, v, ("dp", "fsdp"),
            "cuda")
        torch.cuda.synchronize()
        rec[label] = dict(
            ms=(time.perf_counter() - t0) * 1e3,
            rel_errs=[((x.float() - y.float()).abs().max()
                       / y.float().abs().max()).item()
                      for x, y in zip(got, ref)])
    if dist.get_rank() == 0:
        print(json.dumps({"world": world, **rec}), flush=True)
    dist.destroy_process_group()


def parallel_entries(entry, kring, sp_run, fwd90, bwd90) -> list:
    """The kernels line's entries of the parallel phases: the ring's K5 and
    K8 hops and the Ulysses local call, each with the launches of the
    collective path's run (sp-collective)."""
    hop5, hop8, uly = (kring["K5 ring hop"], kring["K8 ring hop"],
                       kring["Ulysses local"])
    return [
        entry("flash_fwd_sm90 K3's kernel, online with the LSE, d = 128, a "
              "ring hop over one key block (HunyuanVideo 720p, P = 4) "
              "(K5)", fwd90, 867, "K5", hop5, design="d128",
              launches_n=sp_run["hops_k5"],
              extra={k: hop5[k] for k in ("ring_ms", "unsharded_ms",
                                          "ring_max_abs_err",
                                          "ring_lse_err")},
              status="redesigned for Hopper (K3's kernel), as a ring hop: "
                     "the LSE merged outside the kernel, checked"),
        entry("flash_bwd_sm90 d=128 single pass, a ring hop with the "
              "global output and LSE (HunyuanVideo LoRA shape, P = 4) (K8)",
              bwd90, 1148, "K8", hop8, design="d128",
              launches_n=sp_run["hops_k8"],
              extra={k: hop8[k] for k in ("ring_ms", "unsharded_ms",
                                          "ring_max_abs_err")},
              status="redesigned for Hopper (flash_bwd_sm90), as a ring "
                     "hop over one key block with the global LSE, checked"),
        entry("flash_fwd_sm90 K3's kernel with the LSE, d = 128, the "
              "Ulysses local call at H/P heads (Wan 2.1 1.3B, P = 2) (K5)",
              fwd90, 867, "K5", uly, design="d128",
              launches_n=sp_run["ulysses_k5"],
              extra=dict({k: v for k, v in uly.items()
                          if k.startswith("bwd_")},
                         bwd_launches=sp_run["ulysses_k8"]),
              status="redesigned for Hopper (K3's kernel; backward "
                     "flash_bwd_sm90), checked"),
    ]


def run_parallel(A) -> tuple:
    """The parallel phases in order (K-ring, K-ulysses, sp-collective,
    reference-parallel, sp-torchrun): (the hop and local-call records, the
    collective path's launch counts)."""
    kring = timed_phase("K-ring", check_ring_hops, A)
    kring["Ulysses local"] = timed_phase("K-ulysses", check_ulysses_local, A)
    sp = timed_phase("sp-collective", run_sp_collective, A)
    timed_phase("reference-parallel", check_parallel_reference, A)
    sp["torchrun"] = timed_phase("sp-torchrun", run_sp_torchrun)
    return kring, sp


def _prefixed(recs: dict, labels: dict) -> dict:
    """{f"{prefix}_{key}": value} of each ``labels`` prefix's record."""
    return {f"{p}_{k}": v for p, lab in labels.items()
            for k, v in recs[lab].items()}


def print_result() -> None:
    """The last line: the device the run took place on."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# ---------------------------------------------------------------- main
def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)   # configs name their defaults relative to the root
    if argv[:1] == ["--parallel-rank"]:
        parallel_rank()   # one torchrun rank of phase 72
        return
    import videotuna_tpu_torch
    if not os.path.abspath(videotuna_tpu_torch.__file__).startswith(ROOT):
        raise SystemExit("chip_smoke: videotuna_tpu_torch is not this "
                         "checkout's")
    from videotuna_tpu_torch import kernels
    import videotuna_tpu_torch.kernels.attention as A

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    report = kernels.build_all()
    for src, info in report.items():
        # registers, spills, and any wgmma serialisation (C751x)
        regs = [l.strip() for l in info["ptxas"].splitlines()
                if "registers" in l or "spill" in l or "C751" in l]
        log("build", source=src, ptxas=" | ".join(regs))
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        built=len(report))
    serialised = [src for src, info in report.items() if "C751" in info["ptxas"]]
    if serialised:
        raise AssertionError(f"ptxas serialised the wgmma of {serialised} "
                             "(C751x): see the build lines")
    if argv[:1] == ["--hunyuan-train"]:
        # one HunyuanVideo LoRA size alone, without resume: the frame cut is
        # chosen from such runs (an out-of-memory error ends it non-zero)
        frames = int(argv[1])
        out = timed_phase("train-hunyuan", run_train_hunyuan, A, frames,
                          False)
        print(json.dumps({"hunyuan_train": {
            "frames": frames, "size": HY_TRAIN_SIZE, "tokens": out["tokens"],
            "peak_gb": out["peak_gb"],
            "free_at_peak_gb": out["free_at_peak_gb"],
            "sec_per_step": out["sec_per_step"]}}), flush=True)
        return

    if argv[:1] == ["--wan"]:
        # the Wan 2.1 phases alone (K3 at Wan's shapes, the narrow
        # card-vs-CPU check, both sampling runs and the traced DiT call)
        k3w = timed_phase("K3-wan", check_k3_wan, A)
        check_small_reference_wan()
        w14 = timed_phase("e2e-wan14b", run_e2e_wan14b, A)
        timed_phase("profile-wan14b", profile_wan14b_call)
        w13 = timed_phase("e2e-wan1.3b", run_e2e_wan1_3b, A)
        print(json.dumps({"wan": {
            "k3": k3w, "wan14b": {k: w14[k] for k in ("peak_gb",
                                                       "sec_per_step")},
            "wan1_3b": {k: w13[k] for k in ("peak_gb", "sec_per_step")}}}),
            flush=True)
        return

    if argv[:1] == ["--cogvideox"]:
        # the CogVideoX i2v and 1.5 phases alone (K1 at 1.5's shape, the
        # narrow card-vs-CPU check, the three sampling runs)
        k1c = timed_phase("K1-cog15", check_k1_cog15, A)
        check_small_reference_cog15()
        out = {tag: timed_phase(tag, fn, A) for tag, fn in (
            ("e2e-cog-i2v", run_e2e_cog_i2v),
            ("e2e-cog15-t2v", run_e2e_cog15_t2v),
            ("e2e-cog15-i2v", run_e2e_cog15_i2v))}
        timed_phase("profile-cog15", profile_cog15_call)
        print(json.dumps({"cogvideox": {"k1_cog15": k1c, **{
            tag: {k: v for k, v in r.items() if k not in ("launches",
                                                         "sm90")}
            for tag, r in out.items()}}}), flush=True)
        print_result()
        return

    if argv[:1] == ["--vc-train"]:
        # the VideoCrafter2 training phases alone: the kernels at a training
        # step's shapes, the narrow card-vs-CPU step and its control, and
        # the full and LoRA fine-tunes ("kernels" or "train" after the flag:
        # the first two or the last alone)
        kvct, out = {}, {}
        if argv[1:2] != ["train"]:
            kvct = timed_phase("K-vct", check_k_vct, A)
            check_train_reference_vc(A)
            check_train_reference_vc(A, control=VCT_CONTROL)
        if argv[1:2] != ["kernels"]:
            out["train-vc2"] = timed_phase("train-vc2", run_train_vc2, A)
            out["train-vc2-lora"] = timed_phase(
                "train-vc2-lora", run_train_vc2_lora, A, out["train-vc2"])
        print(json.dumps({"vc_train": {"k_vct": kvct, **{
            tag: {k: v for k, v in r.items()
                  if k not in ("launches", "sm90", "fingerprint")}
            for tag, r in out.items()}}}), flush=True)
        print_result()
        return

    if argv[:1] in (["--stepvideo"], ["--mochi"]):
        # the StepVideo or the Mochi phases alone: K-step (both families'
        # d = 128 kernels), the family's narrow card-vs-CPU DiT, its
        # sampling run (StepVideo's also the 48-layer DiT step)
        kstep = timed_phase("K-step", check_k_step, A)
        out = {}
        if argv[0] == "--stepvideo":
            check_small_reference_stepvideo(A)
            out["e2e-stepvideo"] = timed_phase("e2e-stepvideo",
                                               run_e2e_stepvideo, A)
            out["dit-stepvideo-48"] = timed_phase(
                "dit-stepvideo-48", run_dit_stepvideo_48, A)
        else:
            check_small_reference_mochi(A)
            out["e2e-mochi"] = timed_phase("e2e-mochi", run_e2e_mochi, A)
        print(json.dumps({argv[0][2:]: {"k_step": kstep, **{
            tag: {k: v for k, v in r.items() if k not in ("launches",
                                                         "sm90")}
            for tag, r in out.items()}}}), flush=True)
        print_result()
        return

    if argv[:1] in (["--flux"], ["--v2v"]):
        # the Flux or the V2V phases alone: K-flux, the narrow card-vs-CPU
        # flow and LoRA step, both sampling runs and the LoRA training; or
        # both V2V runs and the narrow card-vs-CPU check with its control
        out = {}
        if argv[0] == "--flux":
            out["k_flux"] = timed_phase("K-flux", check_k_flux, A)
            check_small_reference_flux(A)
            out["e2e-flux-dev"] = timed_phase(
                "e2e-flux-dev", run_e2e_flux, A, FLUX_DEV_COMMAND,
                FLUX_DEV_STEPS)
            out["e2e-flux-schnell"] = timed_phase(
                "e2e-flux-schnell", run_e2e_flux, A, FLUX_SCHNELL_COMMAND,
                FLUX_SCHNELL_STEPS)
            out["train-flux-lora"] = timed_phase("train-flux-lora",
                                                 run_train_flux, A)
        else:
            out.update(zip(("e2e-v2v-ms", "e2e-v2v-enhance"),
                           timed_phase("e2e-v2v", run_e2e_v2v, A)))
            check_small_reference_v2v()
            check_small_reference_v2v(control=REF_VC_CONTROL)
        print(json.dumps({argv[0][2:]: {
            tag: {k: v for k, v in r.items() if k not in ("launches",
                                                         "sm90")}
            for tag, r in out.items()}}), flush=True)
        print_result()
        return

    if argv[:1] == ["--hunyuan-i2v"]:
        # the HunyuanVideo I2V phases alone: K-f32, the full-width prompt
        # chain, the narrow card-vs-CPU flows and their control, the
        # sampling run
        kf32, enc, e2e = run_hunyuan_i2v(A)
        print(json.dumps({"hunyuan_i2v": {
            "k_f32": kf32, "encode": {k: v for k, v in enc.items()
                                      if k not in ("launches", "sm90")},
            "e2e": {k: v for k, v in e2e.items()
                    if k not in ("launches", "sm90")}}}), flush=True)
        print_result()
        return

    if argv[:1] == ["--opensora12"]:
        # the Open-Sora 1.2 phases alone: K-os12, the narrow card-vs-CPU
        # flows and training step, the sampling run (a step count after
        # the flag cuts it), then one traced STDiT3 call
        steps = int(argv[1]) if len(argv) > 1 else OS12_STEPS
        kos, e2e = run_opensora12(A, steps)
        timed_phase("profile-opensora12", profile_opensora12_call)
        print(json.dumps({"opensora12": {"k_os12": kos, "e2e": {
            k: v for k, v in e2e.items() if k not in ("launches", "sm90")}}}),
            flush=True)
        print_result()
        return

    if argv[:1] == ["--parallel"]:
        # the parallel phases alone: the ring's hops and the Ulysses local
        # call at full width, the collective path on threaded ranks, the
        # narrow P = 2 checks, torchrun ranks where there are cards
        kring, sp_run = run_parallel(A)
        print(json.dumps({"parallel": {"k_ring": kring, "sp": sp_run}}),
              flush=True)
        print_result()
        return

    if argv[:1] == ["--serve"]:
        # the serving phases alone: K2 and K4 at the 4-slot engine's
        # shapes, the narrow card-vs-CPU engines and int8 flow, the three
        # services and int8 at full width
        kserve, rec, _ = run_serving(A)
        print(json.dumps({"serve": {"k_serve": kserve, **rec}}), flush=True)
        print_result()
        return

    if argv[:1] == ["--videocrafter"]:
        # the VideoCrafter, DynamiCrafter and Wan I2V phases alone (the
        # kernels at their shapes, the narrow card-vs-CPU checks, the
        # sampling runs and the traced DynamiCrafter UNet call)
        kvc = timed_phase("K-vc", check_k_vc, A)
        check_small_reference_vc()
        check_small_reference_vc(control=REF_VC_CONTROL)
        out = {"e2e-vc2": timed_phase("e2e-vc2", run_e2e_vc2, A),
               "e2e-dc": timed_phase("e2e-dc", run_e2e_dc, A)}
        out.update(zip(("e2e-vc1-t2v", "e2e-vc1-i2v"),
                       timed_phase("e2e-vc1", run_e2e_vc1, A)))
        timed_phase("profile-dc", profile_dc_call)
        out["e2e-wan-i2v"] = timed_phase("e2e-wan-i2v", run_e2e_wan_i2v, A)
        print(json.dumps({"videocrafter": {"k_vc": kvc, **{
            tag: {k: v for k, v in r.items() if k not in ("launches",
                                                         "sm90")}
            for tag, r in out.items()}}}), flush=True)
        print_result()
        return

    # every timed phase under PyTorch's defaults, its flags logged first;
    # the card-vs-CPU checks turn TF32 off inside and restore it
    k1 = timed_phase("K1", check_k1, A)
    k6 = k1.pop("k6")
    k1c = timed_phase("K1-cog15", check_k1_cog15, A)
    k2 = timed_phase("K2", check_k2, A)
    k4 = timed_phase("K4", check_k4, A)
    k3 = timed_phase("K3", check_k3, A)
    k3w = timed_phase("K3-wan", check_k3_wan, A)
    bwd = timed_phase("bwd", check_bwd, A)
    k1["train_lse_ms"] = bwd["K1_train"]["ms"]
    timed_phase("f32", check_f32_forward, A)
    runs = [timed_phase("e2e", run_e2e, A)]
    check_small_reference()
    cog15_runs = [timed_phase("e2e-cog15-t2v", run_e2e_cog15_t2v, A),
                  timed_phase("e2e-cog15-i2v", run_e2e_cog15_i2v, A)]
    runs += [timed_phase("e2e-cog-i2v", run_e2e_cog_i2v, A)] + cog15_runs
    check_small_reference_cog15()
    timed_phase("profile-cog15", profile_cog15_call)
    runs.append(timed_phase("e2e-opensora", run_e2e_opensora, A))
    check_small_reference_opensora()
    timed_phase("profile-opensora", profile_opensora_call)
    cog = timed_phase("train-cog", run_train_cog, A)
    stdit = timed_phase("train-stdit", run_train_stdit, A)
    runs += [cog, stdit]
    check_train_reference(A)
    runs.append(timed_phase("e2e-hunyuan", run_e2e_hunyuan, A))
    check_small_reference_hunyuan()
    timed_phase("profile-hunyuan", profile_hunyuan_call)
    runs.append(timed_phase("train-hunyuan", run_train_hunyuan, A))
    wan_runs = [timed_phase("e2e-wan14b", run_e2e_wan14b, A)]
    check_small_reference_wan()
    timed_phase("profile-wan14b", profile_wan14b_call)
    wan_runs.append(timed_phase("e2e-wan1.3b", run_e2e_wan1_3b, A))
    runs += wan_runs
    kvc = timed_phase("K-vc", check_k_vc, A)
    check_small_reference_vc()
    check_small_reference_vc(control=REF_VC_CONTROL)
    vc_runs = [timed_phase("e2e-vc2", run_e2e_vc2, A),
               timed_phase("e2e-dc", run_e2e_dc, A),
               *timed_phase("e2e-vc1", run_e2e_vc1, A)]
    timed_phase("profile-dc", profile_dc_call)
    wan_i2v = timed_phase("e2e-wan-i2v", run_e2e_wan_i2v, A)
    runs += vc_runs + [wan_i2v]
    kvct = timed_phase("K-vct", check_k_vct, A)
    check_train_reference_vc(A)
    check_train_reference_vc(A, control=VCT_CONTROL)
    vc2_train = timed_phase("train-vc2", run_train_vc2, A)
    vct_runs = [vc2_train, timed_phase("train-vc2-lora", run_train_vc2_lora,
                                       A, vc2_train)]
    runs += vct_runs
    kstep, step_runs, dit48 = run_stepvideo_mochi(A)
    runs += step_runs
    kflux, flux_runs, flux_train, v2v_runs = run_flux_v2v(A)
    runs += flux_runs + [flux_train] + v2v_runs
    kf32, i2v_encode, hy_i2v = run_hunyuan_i2v(A)
    kos12, os12 = run_opensora12(A, OS12_WHOLE_STEPS)
    kserve, _, serve_run = run_serving(A)
    runs += [i2v_encode, hy_i2v, os12, serve_run]
    kring, sp_run = run_parallel(A)
    timed_phase("device", device_times, A, k2, bwd["K5"], k4, bwd["K8"])
    # each kernel's launches over the main-path runs
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    sm90 = {k: sum(r["sm90"][k] for r in runs) for k in launches}
    # of those, the Hopper designs' launches at d = 128 (K3's kernel for K3
    # and K5, flash_bwd_sm90 for K8 and K9): counted apart, so that the
    # d = 72 entries of K5, K8 and K9 hold STDiT's launches alone
    d128 = {k: sum(r["sm90"][f"{k}_d128"] for r in runs) for k in launches}
    # the f32 design's launches (LLaMA's K2), also counted apart
    f32 = {k: sum(r["sm90"].get(f"{k}_f32", 0) for r in runs)
           for k in launches}
    # K3's launches in the Wan runs, apart from HunyuanVideo's
    wan_k3 = sum(r["sm90"]["K3_d128"] for r in wan_runs)
    # K1's launches at CogVideoX 1.5's 9,674 tokens, apart from the 5B's
    cog15_k1 = sum(r["sm90"]["K1"] for r in cog15_runs)
    # the UNet's K2 (d = 64, 5 heads) and K1 launches, apart from STDiT's
    # and CogVideoX's; the CLIP image encoder's f32 K2 on the f32 design
    # (those runs' only f32 launches); Wan I2V's K3 launches
    vc_k2 = sum(r["sm90"]["K2"] for r in vc_runs + v2v_runs)
    vc_k1 = sum(r["sm90"]["K1"] for r in vc_runs + v2v_runs)
    clip_k2 = sum(r["sm90"]["K2_f32"] for r in vc_runs + [wan_i2v])
    # the HunyuanVideo I2V prompt chain's f32 launches: the LLaVA tower's
    # K1 (d = 64) and the LLaMA's K2 over 934 tokens; Open-Sora 1.2's K2
    # and K4 (d = 72, 3,600 tokens a frame) on the persistent kernel
    llava_k1 = i2v_encode["sm90"]["K1_f32"]
    i2v_llama_k2 = i2v_encode["sm90"]["K2_f32"]
    os12_k2, os12_k4 = os12["sm90"]["K2"], os12["sm90"]["K4"]
    # the served STDiT-XL/2's K2 and K4 (the three services and int8)
    serve_k2, serve_k4 = serve_run["sm90"]["K2"], serve_run["sm90"]["K4"]
    wan_i2v_k3 = wan_i2v["sm90"]["K3_d128"]
    # VideoCrafter2 training's launches (K5 and K8 at d = 64 on the Hopper
    # designs, K1 with the LSE and K7), apart from the other runs'
    vct = {k: sum(r["sm90"][k] for r in vct_runs)
           for k in ("K1", "K5", "K7", "K8", "K7_rows", "K8_rows")}
    # StepVideo's K2 and K4 and Mochi's K4 on K3's kernel at d = 128 (and
    # the 48-layer DiT step's, run apart), StepLLM's f32 K2
    step, mochi = step_runs
    step_k2 = step["sm90"]["K2_d128"] + dit48["sm90"]["K2_d128"]
    step_k4 = step["sm90"]["K4_d128"] + dit48["sm90"]["K4_d128"]
    mochi_k4 = mochi["sm90"]["K4_d128"]
    stepllm_k2 = step["sm90"]["K2_f32"]
    # Flux's K2 (dev and schnell sampling) on K3's kernel at d = 128 with
    # the online max; its training's K5 (online, with the LSE) and K8 there
    flux_k2 = sum(r["sm90"]["K2_d128"] for r in flux_runs)
    flux_k5 = flux_train["sm90"]["K5_d128"]
    flux_k8 = flux_train["sm90"]["K8_d128"]

    statuses = {
        "K1": "redesigned for Hopper (flash_fwd_sm90 persistent, d=64 "
              "bf16, fixed max or online, optional LSE), checked",
        "K2": "redesigned for Hopper (flash_fwd_sm90 persistent, d=64/72/80 "
              "bf16; K3's kernel with the online max at d=128 bf16), "
              "checked; f32 at d=64/80/128 (LLaMA's causal K2, the CLIP "
              "towers) redesigned for Hopper (flash_fwd_f32_sm90: split key "
              "ranges, a cp.async ring, the combine), checked",
        "K3": "redesigned for Hopper (flash_fwd_sm90: TMA, wgmma, "
              "warp-specialised), checked",
        "K4": "redesigned for Hopper (flash_fwd_sm90 persistent with the "
              "key mask, d=72/80 bf16; K3's kernel with the key mask, online "
              "or fixed max, d=128 bf16), checked",
        "K5": "redesigned for Hopper (flash_fwd_sm90 persistent with the "
              "LSE, d=64/72/80 bf16, d=64 the UNet's training; K3's kernel "
              "with the LSE at d=128 under the fixed max, HunyuanVideo "
              "training, and online, Flux training), checked",
        "K6": "redesigned for Hopper (flash_fwd_sm90 persistent with a "
              "key-range split and the combine, online), checked",
        "K7": "redesigned for Hopper (flash_bwd_sm90: single pass, wgmma), "
              "checked",
        "K8": "redesigned for Hopper (flash_bwd_rows_sm90: single pass, "
              "persistent, d=72/80 bf16, key mask as bit words; "
              "flash_bwd_sm90 at d=64 and d=128 unmasked, the UNet's and "
              "HunyuanVideo's training), checked",
        "K9": "mapped onto K8's kernels (flash_bwd_rows_sm90 at d=72/80, "
              "flash_bwd_sm90 at d=128), checked",
        "K10": "mapped onto K7's kernel (flash_bwd_sm90), checked"}
    log("kernels", **statuses)
    fwd90 = "videotuna_tpu_torch/kernels/csrc/flash_fwd_sm90.cu"
    rows90 = "videotuna_tpu_torch/kernels/csrc/flash_bwd_rows_sm90.cu"
    bwd90 = "videotuna_tpu_torch/kernels/csrc/flash_bwd_sm90.cu"
    fwd32 = "videotuna_tpu_torch/kernels/csrc/flash_fwd_f32_sm90.cu"
    bwd_mma = "videotuna_tpu_torch/kernels/csrc/flash_bwd.cu"
    tpu = "videotuna_tpu/kernels/attention.py"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    extra_keys = ("other_design_ms", "other_design_device_ms", "lse_err",
                  "old_design_ms", "device_ms", "old_design_device_ms",
                  "library_device_ms", "lse_device_ms",
                  "lse_old_design_device_ms", "train_lse_ms", "host_ms",
                  "old_design_host_ms", "unsplit_ms", "unsplit_device_ms",
                  "unsplit_host_ms") + tuple(
        f"cross_{k}" for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "old_design_ms",
                               "device_ms", "old_design_device_ms",
                               "library_device_ms", "host_ms",
                               "old_design_host_ms")) + tuple(
        f"llama_{k}" for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")) + tuple(
        f"{p}_{k}" for p in ("wan13", "cross") for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms")) + ("ms_again",) + tuple(
        f"{p}_{k}" for p in ("vc2_self", "vc2_cross", "dc_cross",
                             "vc2_ds2_self", "vc2_ds4_self", "dc_ds4_self",
                             "vc2_ds2_cross", "vc2_ds4_cross",
                             "dc_ds2_cross", "dc_ds4_cross", "dc_mid_self",
                             "dc_mid_cross", "dc_image_cross",
                             "dc_ds2_image_cross", "dc_ds4_image_cross",
                             "dc_mid_image_cross")
        for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms", "library_device_ms",
                  "old_design_ms", "old_design_device_ms", "ms_again"))

    def entry(name, source, replaces, kernel, rec, design="sm90",
              status=None, launches_n=None, extra=None):
        # a redesigned kernel adds the old design's ms on the same tensors
        # (K2, K4, K5: and the device times of both designs and the
        # library; K1: its time at the training shape with the LSE; K6 and
        # LLaMA's K2: device and host times, K6 its unsplit walk's); its
        # launches are those of this entry's design: the Hopper kernel's at
        # the route's other widths ("sm90") or at d = 128 ("d128"), the f32
        # design's ("f32"), or the rest of the route's on flash_fwd.cu /
        # flash_bwd.cu ("mma")
        old = {k: rec[k] for k in extra_keys if k in rec}
        n = {"sm90": sm90[kernel] - d128[kernel], "d128": d128[kernel],
             "f32": f32[kernel],
             "mma": launches[kernel] - sm90[kernel] - f32[kernel]}[design]
        n = n if launches_n is None else launches_n
        return {"name": name, "route": "cuda", "source": source,
                "replaces": f"{tpu}:{replaces}", "launches": n,
                **{k: rec[k] for k in keys}, **old, **(extra or {}),
                "status": status or statuses[kernel]}

    def fields(rec, prefix):
        return {k: rec[f"{prefix}_{k}"] for k in keys + (
            "old_design_ms", "device_ms", "host_ms", "old_design_device_ms",
            "old_design_host_ms", "library_device_ms")
            if f"{prefix}_{k}" in rec}

    print(json.dumps({"kernels": [
        entry("flash_fwd_sm90 persistent, d=64 (K1)", fwd90, 268, "K1", k1,
              launches_n=sm90["K1"] - d128["K1"] - cog15_k1 - vc_k1
              - vct["K1"]),
        # CogVideoX 1.5's joint attention on the same kernel (9,674 tokens)
        entry("flash_fwd_sm90 persistent, d=64, CogVideoX 1.5 (K1)", fwd90,
              268, "K1", k1c, launches_n=cog15_k1),
        entry("flash_fwd_sm90 persistent, d=72 online (K2)", fwd90, 78,
              "K2", k2, launches_n=sm90["K2"] - d128["K2"] - vc_k2 - os12_k2
              - serve_k2),
        # Open-Sora 1.2 at 720p on the same kernel: the spatial K2 (B = 60,
        # 3,600 tokens) and the cross-attention K4 over T5's 300 keys
        entry("flash_fwd_sm90 persistent, d=72 online, Open-Sora 1.2 "
              "spatial 3,600 tokens (K2)", fwd90, 78, "K2",
              kos12["K2 os12 spatial"], launches_n=os12_k2),
        entry("flash_fwd_sm90 persistent, key mask, d=72, Open-Sora 1.2 "
              "cross-attention over 300 T5 keys (K4)", fwd90, 970, "K4",
              kos12["K4 os12 cross"], launches_n=os12_k4),
        # the UNet's attention (VideoCrafter2 at 320x512, DynamiCrafter at
        # 576x1024, B = 32): level 1's 5 heads on K2 (DynamiCrafter's self-
        # attention's figures; VideoCrafter2's and the 77-key cross-
        # attention's as vc2_self_*, vc2_cross_*, dc_cross_*, with the old
        # design's on the same tensors), and the K1 levels (DynamiCrafter's
        # level-2 self-attention's figures; the other shapes under their
        # labels)
        entry("flash_fwd_sm90 persistent, d=64 online, 5 heads, UNet3D "
              "level 1 (K2)", fwd90, 78, "K2",
              dict(kvc["K2 dc self"], **{
                  f"{p}_{k}": v for p, lab in (
                      ("vc2_self", "K2 vc2 self"),
                      ("vc2_cross", "K2 vc2 cross"),
                      ("dc_cross", "K2 dc cross"),
                      ("dc_image_cross", "K2 dc image cross"))
                  for k, v in kvc[lab].items()}), launches_n=vc_k2),
        entry("flash_fwd_sm90 persistent, d=64 online, UNet3D levels 2 and "
              "4 and the middle (K1)", fwd90, 268, "K1",
              dict(kvc["K1 dc ds2 self"], **{
                  lab.replace(" ", "_").lower()[3:] + "_" + k: v
                  for lab, rec in kvc.items() if lab.startswith("K1")
                  and lab != "K1 dc ds2 self" for k, v in rec.items()}),
              launches_n=vc_k1),
        entry("flash_fwd_f32_sm90 f32, d=80, split key ranges, the CLIP "
              "ViT-H/14 image encoder (K2)", fwd32, 78, "K2",
              kf32["K2 f32 clip"], design="f32", launches_n=clip_k2,
              status="redesigned for Hopper (flash_fwd_f32_sm90 at D=80), "
                     "checked"),
        entry("flash_fwd_f32_sm90 f32, d=64, the LLaVA CLIP ViT-L/14-336 "
              "tower (K1)", fwd32, 268, "K1", kf32["K1 f32 llava"],
              design="f32", launches_n=llava_k1,
              status="redesigned for Hopper (flash_fwd_f32_sm90 at D=64), "
                     "checked"),
        entry("flash_fwd_sm90 static_max, d = 128 (K3)", fwd90, 581,
              "K3", k3, design="d128",
              launches_n=d128["K3"] - wan_k3 - wan_i2v_k3),
        # Wan 2.1 I2V's self-, text and image cross-attention on the same
        # kernel, timed at the image cross-attention (75,600 x 256 keys)
        entry("flash_fwd_sm90 static_max, d = 128, Wan 2.1 I2V (K3)", fwd90,
              581, "K3", kvc["K3 wan i2v image cross"], design="d128",
              launches_n=wan_i2v_k3),
        # Wan 2.1's self- and text cross-attention on the same kernel: the
        # 14B self-attention's figures, the 14B cross-attention's as
        # cross_*, the 1.3B self-attention's as wan13_*
        entry("flash_fwd_sm90 static_max, d = 128, Wan 2.1 self- and "
              "cross-attention (K3)", fwd90, 581, "K3",
              dict(k3w["self 14B"],
                   **{f"cross_{k}": v for k, v in k3w["cross 14B"].items()},
                   **{f"wan13_{k}": v
                      for k, v in k3w["self 1.3B"].items()}),
              design="d128", launches_n=wan_k3),
        entry("flash_fwd_sm90 persistent, key mask (K4)", fwd90, 970, "K4",
              k4, launches_n=sm90["K4"] - d128["K4"] - os12_k4 - serve_k4),
        # the served STDiT-XL/2 at the 4-slot engine's shapes (B = 8 under
        # CFG): the spatial K2 over 128 sequences of 256 tokens and the
        # cross K4 over 120 T5 keys; launches over the three services and
        # int8, with those of one solo request and of one engine step
        entry("flash_fwd_sm90 persistent, d=72 online, the 4-slot serving "
              "engine's spatial attention, B = 128 (K2)", fwd90, 78, "K2",
              kserve["K2 serve spatial"], launches_n=serve_k2,
              extra=dict(launches_per_request=OS_DEPTH * OS_STEPS,
                         launches_per_engine_step=OS_DEPTH)),
        entry("flash_fwd_sm90 persistent, key mask, d=72, the 4-slot serving "
              "engine's cross-attention over 120 T5 keys (K4)", fwd90, 970,
              "K4", kserve["K4 serve cross"], launches_n=serve_k4,
              extra=dict(launches_per_request=OS_DEPTH * OS_STEPS,
                         launches_per_engine_step=OS_DEPTH)),
        # StepVideo's and Mochi's attention on K3's kernel at d = 128: the
        # self-attention with the online max (K2), the cross-attention
        # over the CLIP and caption keys with the mask (K4, online), Mochi's
        # joint attention with the caption mask under the fixed max (K4);
        # flash_fwd.cu's time on the same tensors as old_design_ms
        entry("flash_fwd_sm90 K3's kernel, online, d = 128, StepVideo "
              "self-attention (K2)", fwd90, 78, "K2", kstep["step self"],
              design="d128", launches_n=step_k2),
        entry("flash_fwd_sm90 K3's kernel, key mask, online, d = 128, "
              "StepVideo cross-attention (K4)", fwd90, 970, "K4",
              kstep["step cross"], design="d128", launches_n=step_k4),
        entry("flash_fwd_sm90 K3's kernel, key mask, fixed max, d = 128, "
              "Mochi joint attention (K4)", fwd90, 970, "K4",
              kstep["mochi joint"], design="d128", launches_n=mochi_k4),
        entry("flash_fwd_f32_sm90 f32 causal, StepLLM (K2)", fwd32, 78,
              "K2", kstep["stepllm"], design="f32", launches_n=stepllm_k2,
              status="redesigned for Hopper (flash_fwd_f32_sm90), "
                     "checked"),
        entry("flash_fwd_sm90 persistent with the LSE, training forward "
              "(K5)", fwd90, 867, "K5", bwd["K5"],
              launches_n=sm90["K5"] - d128["K5"] - vct["K5"]),
        entry("flash_fwd_sm90 persistent online with a key-range split and "
              "the combine, pack2=True (K6)", fwd90, 163, "K6", k6),
        entry("flash_bwd_sm90 d=64 single pass (K7)", bwd90, 1424, "K7",
              bwd["K7"], launches_n=sm90["K7"] - d128["K7"] - vct["K7"]),
        entry("flash_bwd_rows_sm90 single pass, spatial and key-masked "
              "cross (K8)", rows90, 1148, "K8", bwd["K8"],
              launches_n=sm90["K8"] - d128["K8"] - vct["K8"]),
        entry("flash_bwd_rows_sm90 single_pass=False, generic (K9)", rows90,
              1107, "K9", bwd["K9"]),
        entry("flash_bwd_sm90 single_pass=False, d=64 (K10)", bwd90, 1260,
              "K10", bwd["K10"]),
        # HunyuanVideo training's d=128 cases of K5 and K8 on the Hopper
        # designs, with the old design's ms on the same tensors
        entry("flash_fwd_sm90 K3's kernel with the LSE, d=128, HunyuanVideo "
              "training (K5)", fwd90, 867, "K5", fields(bwd["K5"], "d128"),
              design="d128", launches_n=d128["K5"] - flux_k5),
        entry("flash_bwd_sm90 d=128 single pass, HunyuanVideo training (K8)",
              bwd90, 1148, "K8", fields(bwd["K8"], "d128"), design="d128",
              launches_n=d128["K8"] - flux_k8),
        # Flux: sampling's joint attention (K2, online, 4,592 tokens) and
        # LoRA training's (K5 online with the LSE, K8; 2,816 tokens), with
        # the old designs' and SDPA's device times
        entry("flash_fwd_sm90 K3's kernel, online, d = 128, Flux sampling "
              "joint attention (K2)", fwd90, 78, "K2", kflux["K2"],
              design="d128", launches_n=flux_k2),
        entry("flash_fwd_sm90 K3's kernel, online with the LSE, d = 128, "
              "Flux training (K5)", fwd90, 867, "K5", kflux["K5"],
              design="d128", launches_n=flux_k5),
        entry("flash_bwd_sm90 d=128 single pass, Flux training (K8)", bwd90,
              1148, "K8", kflux["K8"], design="d128", launches_n=flux_k8),
        # VideoCrafter2 training's attention (B = 16 frames, d = 64): K5
        # at level 1 (5 heads; the self-attention's figures, the 77-key
        # cross-attention's as cross_*, K5 over 77 keys at levels 2 and 4
        # as ds2_cross_*, ds4_cross_*), K8 at level 1, K1 with the LSE and
        # K7 at levels 2 and 4 (640², and 160² as ds4_*); each backward
        # over 77 keys on flash_bwd_rows_sm90, with flash_bwd_sm90's time
        # on the same tensors as other_design_*
        entry("flash_fwd_sm90 persistent with the LSE, d=64, UNet3D "
              "training level 1 and the text cross-attention (K5)", fwd90,
              867, "K5", kvct["K5 self"], launches_n=vct["K5"],
              extra=_prefixed(kvct, {"cross": "K5 cross",
                                     "ds2_cross": "K5 ds2 cross",
                                     "ds4_cross": "K5 ds4 cross"})),
        entry("flash_bwd_sm90 d=64 single pass, UNet3D training level 1 "
              "self-attention (K8)", bwd90, 1148, "K8", kvct["K8 self"],
              launches_n=vct["K8"] - vct["K8_rows"]),
        entry("flash_bwd_rows_sm90 d=64 single pass, UNet3D training level "
              "1 over 77 text keys (K8)", rows90, 1148, "K8",
              kvct["K8 cross"], launches_n=vct["K8_rows"]),
        entry("flash_fwd_sm90 persistent with the LSE, d=64, UNet3D "
              "training levels 2 and 4 (K1)", fwd90, 268, "K1",
              kvct["K1 ds2 self"], launches_n=vct["K1"],
              extra=_prefixed(kvct, {"ds4_self": "K1 ds4 self"})),
        entry("flash_bwd_sm90 d=64 single pass, UNet3D training levels 2 "
              "and 4 self-attention (K7)", bwd90, 1424, "K7",
              kvct["K7 ds2 self"], launches_n=vct["K7"] - vct["K7_rows"],
              extra=_prefixed(kvct, {"ds4_self": "K7 ds4 self"})),
        entry("flash_bwd_rows_sm90 d=64 single pass, UNet3D training levels "
              "2 and 4 over 77 text keys (K7)", rows90, 1424, "K7",
              kvct["K7 ds2 cross"], launches_n=vct["K7_rows"],
              extra=_prefixed(kvct, {"ds4_cross": "K7 ds4 cross"})),
        # LLaMA's f32 causal K2 on the f32 design
        entry("flash_fwd_f32_sm90 f32 causal, split key ranges, LLaMA (K2)",
              fwd32, 78, "K2", fields(k2, "llama"), design="f32",
              launches_n=f32["K2"] - stepllm_k2 - clip_k2 - i2v_llama_k2,
              status="redesigned for Hopper (flash_fwd_f32_sm90: split key "
                     "ranges, a cp.async ring, three bf16 products a "
                     "product, the combine), checked"),
        entry("flash_fwd_f32_sm90 f32 causal, unsplit, LLaMA over the "
              "HunyuanVideo I2V prompt's 934 tokens (K2)", fwd32, 78, "K2",
              kf32["K2 f32 llama i2v"], design="f32",
              launches_n=i2v_llama_k2,
              status="redesigned for Hopper (flash_fwd_f32_sm90), "
                     "checked"),
        *parallel_entries(entry, kring, sp_run, fwd90, bwd90),
    ]}), flush=True)
    print_result()


if __name__ == "__main__":
    main()
