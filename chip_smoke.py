#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``autoawq_tpu_torch``) on one card.

    python3 chip_smoke.py              # every phase, needs one CUDA device
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --root DIR --phases device,prefill   # A/B
    python3 chip_smoke.py --root DIR --phases device,paged     # A/B
    python3 chip_smoke.py --root DIR --phases device,linears   # A/B
    python3 chip_smoke.py --root DIR --phases device,decode_mlp_attn  # A/B
    python3 chip_smoke.py --root DIR --phases device,attn_bwd  # A/B

Phases, each printing JSON lines:

1. device   — card name and count, torch / CUDA versions, nvidia-smi's name
              and power limit.
2. build    — compiles the eleven kernels from ``autoawq_tpu_torch/csrc``
              (ten sources: K10 and K11 share one; one nvcc per source,
              in parallel) and prints ptxas' register and
              shared-memory summary for each.
3. kernels  — each kernel at the main path's shapes against its plain twin
              on the same inputs: max abs / rel error with the tolerance,
              CUDA-event times of CUDA-graph replays (kernel, plain twin,
              one PyTorch library call where one computes the same
              function; the kernel's eager per-call time beside them) and
              the least time the card could take (bound). K1 also at
              Mistral's qkv and o at M = 1, 8 and 64. K3 also at
              Mistral's MLP at M = 1 and 8; K3 and K8 beside the port's
              unfused chain on K1 (gate_up or gate and up, act * up,
              down) on the same weights. K2 and K4 also
              at traffic D's prefill shapes (Mistral's four linears at
              M = 16,384; B=8, S=2048, 32/8 heads, hd 128). K7 and K9 also
              at their splits' edges and on a long table (8 slots of 4096
              rows, timed with its bound and yardstick). K10 and K11 (K4's
              backward) against the twin's gradients at traffic W's step
              (B=4, S=512, 32/8 heads, hd 128; timed, with the port's
              whole backward beside SDPA's, the yardstick, its backend
              pinned and named, timed from a CUDA graph as the kernels
              are), TinyLlama's heads, GPT-J's hd 256, S = 300, B = 1, a
              padded hd 96, S = 1000 at rep 8 and hd 256 with GQA; a
              second call bit-equal to the first; K4's ``out`` bit-equal
              with and without its log-sum-exp output. The build phase
              fails if K10 or K11 spills at hd 64 or 128. Past the widest
              head (hd 320): a 2 x 128 prompt and a paged step take the
              plain routes (no K4, no K7) within the teacher-forced rule.
4. e2e      — TinyLlama-1.1B at full width (22 layers, seed-0 synthetic
              weights, bf16, fused qkv / gate_up). Traffic A: bs1, 64-token
              prompt, greedy decode, decode tok/s by the difference quotient
              of 128 and 32 new tokens (min of 2 each; ``DECODE_BIG``).
              Traffic B: bs2, two
              384-token prompts, 32 new tokens, prefill seconds. Launch
              counts are zeroed before each traffic and read after it.
              torch.profiler windows over 16 decode steps of traffic A and
              3 prefills of traffic B give host ms, device ms, the device's
              busy share and device time by kernel.
              Then the kernel path against the plain path on the card,
              teacher-forced on the same tokens. Traffic G: the same
              TinyLlama unfused (q/k/v and gate/up separate, the layout
              the facade's default ``from_quantized`` keeps) through
              ``AwqCausalLM.generate``, decode tok/s by A's method, and
              its kernel path against the plain path as A's.
              Then Mistral-7B at full width, ``E2E_MISTRAL_DEPTH`` (8) of
              its 32 layers (seed-0 weights drawn on the card, fused).
              Traffic C: bs8, eight 64-token prompts, 64 new
              tokens, bf16 cache of capacity 128. Traffic D: bs8, eight
              2048-token prompts, 64 new tokens, int8 cache of capacity
              2112. Each: decode tok/s (B times the difference quotient of
              a 64- and a 16-token generation), prefill seconds, launches
              per decode step, a profile of 8 decode steps, and the
              teacher-forced check with the traffic's cache type; D also
              a profile of one prefill.
              Then the same Mistral through the paged engine
              (``serve/paged.PagedBatchingEngine``, 8 slots, 64-row pages,
              8 a slot, 136 in the pool). Traffic H: 16 requests of 64
              seeded tokens, 128 new tokens each, greedy, prefix cache on,
              decode attention through K7: steady-state decode tok/s with
              the 8 slots busy (8 times the difference quotient of 64 and
              16 ``step()`` calls after an untimed admission, min of 2),
              the whole run's tok/s, launches per step held exactly (K7
              16, K1 32, K3 16, K5 0 at 16 layers), a profile of 8 steps
              and the
              teacher-forced check of the paged step against
              ``method="plain"``. Traffic I: H's steady state on an int8
              pool (K7 folds the scales). Traffic J: H's steady state
              through K9 (``paged_attn="stock"``). Traffic K: the HTTP
              server (``start_server(engine, port=0, burst=16)``) on
              loopback over a pool of 7 pages a slot and 120 pages: two
              warm-up clients, then 16 concurrent SSE clients, each a
              shared 256-token system prefix plus its own 64 tokens, 64
              new tokens: throughput, TTFT p50 / p95, prefix hits and
              reused pages held exactly, then ``run(burst=16)`` against
              ``run(burst=1)`` on the same 8 requests.
              Then Mixtral-8x7B at full width, depth cut to
              ``MIXTRAL_DEPTH`` (2) of 32 layers (8 experts, top-2, seed-0
              weights drawn on the card, experts stacked). Traffic
              E: bs1, one 64-token prompt, bf16 cache of capacity 128.
              Traffic F: bs8, eight 512-token prompts, bf16 cache of
              capacity 576. Each as C, plus F's prefill profile, a
              teacher-forced check that holds the routing flips against
              the f32 run and the logits with the f32 run's expert choice
              replayed, and the MoE block held per layer: on hidden states
              the kernel path recorded (first and last layer, prefill and
              first decode step), moe_align's tables on the card equal the
              CPU's bit for bit, and moe_block on the card is held against
              a dense f32 reference that uses no routing table.
5. load     — writes a 2-layer TinyLlama-width AutoAWQ GEMM checkpoint,
              loads it with ``AutoAWQForCausalLM.from_quantized``, unfused
              (the default; decode through K8, two launches a step) and
              fused, and checks each one's logits against the model built
              in memory from the same nibbles.
6. quantize — AWQ on the card. TinyLlama at full width and depth (seed-0
              f32 float weights drawn on the card, hot embedding columns
              0-5 x 8) quantized through the facade on ``QUANT_CALIB``
              (64 x 512) seeded calibration ids (g128, zero point, scale
              and clip search, f32): wall seconds split into tapped
              forwards, scale search, clip search and packing, peak
              memory, layer 0's chosen ratio indices. Saved with
              ``save_quantized``, reloaded (qweight / qzeros bit for bit,
              scales equal to the fp16-rounded ones) and served fused:
              prefill 2 x 384 (K2, K4), greedy decode of 32 tokens at bs1
              (K1, K3), launches read after, teacher-forced logits against
              the plain twins. Quality: 8 x 512 held-out tokens sampled
              from the float model at temperature 1; KL report and
              perplexity of AWQ and of round-to-nearest against it; AWQ's
              mean KL must be below RTN's. The run quantizes the lm_head
              too (``quantize_lm_head``, from the last layer's stream):
              the checks above use the float head; the quantized head's KL
              against it on the same held-out tokens, its save / reload
              and its K1 launch a decode step (45) are held apart. The
              model saved as gemv and gemv_fast, and a symmetric
              round-to-nearest one as GEMM and marlin, each reloaded with
              its greedy stream equal to its GEMM checkpoint's; save /
              reload seconds through the native host packer. A
              ``resume_dir`` run (2 layers, 32 x 512 ids) run again over
              its own files: no layer searched, the tree equal, both
              runs' seconds. Then Mistral-7B at full width,
              cut to ``QUANT_MISTRAL_LAYERS`` (1) of 32 layers: seconds a
              layer and peak memory.
              Then MPT-7B at full width, cut to ``QUANT_MPT_LAYERS`` (1) of 32
              layers (f32 float weights drawn on the card, hot embedding
              columns): quantized through the facade as TinyLlama (its
              GELU's ``act`` scale group), saved (every layer's
              ``ffn.act.scales`` in the files), reloaded (nibbles, scales,
              zeros and ``act_scale`` equal to the in-memory model's) and
              served: one prefill of 2 x 384 (K2 4 a layer, K4 0), 16
              teacher-forced bs1 decode steps (K1 4 a layer a step) and
              one paged step at bs8 (K1 4 and K7 1 with ALiBi slopes a
              layer), launches held exactly; AWQ's mean KL below RTN's as
              TinyLlama's. Then GPT-J-6B at full width, cut to
              ``QUANT_GPTJ_LAYERS`` (1) of 28 layers, quantized alone: the
              whole-block inspect and the ``act`` group, seconds a layer,
              peak memory, layer 0's chosen ratio indices. Then
              DeepSeek-V2-Lite at full width, cut to 2 of 27 layers (layer
              0 dense at 10,944, layer 1 MoE with 64 routed experts top-6
              and 2 shared; f32 float weights drawn on the card, hot
              embedding columns), quantized through the facade at g64 on
              ``V2_LITE_CALIB`` (32 x 512) seeded ids (MLA's groups, the
              dense ``moe`` inspect over all 64 experts, the router left
              float): seconds by part, peak memory, AWQ's mean KL below
              RTN's on 8 x 512; saved and reloaded (nibbles, zeros and
              scales equal, kv_b's dense leaf built in memory and at load,
              never written) and served fused: one decode step's launches
              held exactly (K1 6, K3 1, K6 2, K8 1) and 16 teacher-forced
              bs1 steps with the f32 expert choice replayed.
7. zoo      — the decoder zoo at published widths (seeded W4 g128 weights
              with zero points, drawn on the card, bf16). MPT-7B at full
              width and depth (``MPT7B``): kernel rows at its shapes (K1
              at its four linears, K2 at fc1 prefill, K7 with ALiBi at N's
              shape), then traffic L: bs1, 64-token prompt, greedy decode
              through ``generate``, tok/s by the difference quotient of
              128 and 32 new tokens (min of 2), launches per step held
              exactly (K1 128), device ms a step and busy share; traffic
              M: prefill 2 x 384 (K2 at M = 768, ALiBi attention in plain
              ops), seconds and device ms; traffic N: the paged engine in
              H's configuration, 16 requests of 64 seeded tokens, 128 new
              each: steady tok/s, launches per step held exactly (K1 128,
              K7 32 with ALiBi slopes, K9 0); teacher-forced checks of L,
              M and N's paged step. Then Gemma-2-9B, Qwen3-8B and
              GPT-J-6B at published width, depth cut to ``ZOO_DEPTH``:
              kernel rows (K3 gelu-tanh at Gemma-2's MLP, K7 softcap at hd
              256, K4 at Qwen3's and GPT-J's heads), one prefill of
              2 x 384, 16 teacher-forced decode steps at bs1 and one paged
              step at bs8, each held as above with its launches.
8. mla_moe  — MLA and DeepSeek / Qwen3 MoE (seeded W4 weights with zero
              points drawn on the card, bf16). K6 against its twin at
              DeepSeek-V2-Lite's decode and prefill shapes (64 experts,
              top-6), at 128 (Qwen3-30B-A3B) and 256 experts (DeepSeek-V3)
              top-8, and K8 at V2-Lite's shared experts. DeepSeek-V2-Lite
              at full width, ``V2_LITE_DEPTH`` (5) of its 27 layers (g64:
              its dense MLP of 10,944 is no whole number of 128-row
              groups), latent cache
              bytes a token against materialized K/V. Traffic O: bs1,
              64-token prompt, greedy through ``generate``, tok/s by the
              difference quotient of a 64- and a 16-token generation (one
              run each), device ms a step, busy share and the step's byte
              bound, launches per step held exactly (K1 27, K6 16, K8 8,
              K3 1); teacher-forced with the f32 run's expert choice
              replayed (bf16 and int8 latent caches), routing flips held,
              and the MoE block per layer against a dense f32 reference
              with the shared experts. Traffic P: prefill 2 x 384 (K2 62,
              K6 16, K4 0 a prefill), seconds and device ms. Traffic R:
              H's paged configuration and requests on a latent pool,
              steady tok/s, launches as O; the paged
              step teacher-forced (bf16 and int8 pools) and against the
              contiguous latent path on the same rows. Then DeepSeek-V3
              (1 dense + 1 MoE layer: ``first_k_dense_replace`` cut from 3
              to 1) and Qwen3-30B-A3B at published width, depth cut to
              ``MLA_MOE_CUT_DEPTH``: one prefill of 2 x 384, 16
              teacher-forced bs1 steps and one paged step, each held with
              its launches.
9. serve    — the rest of serving. Mistral-7B at full width and depth
              (seed-0 W4 weights drawn on the card, fused). Traffic S:
              bs1 speculative decoding (``serve/speculative``), a 64-token
              prompt, 128 new tokens, k = 4, with a self-draft of the first
              8 layers, with draft = target (all proposals accepted, the
              bonus token), both greedy, and the self-draft at temperature
              0.8 for 32 tokens twice under one seed (the streams equal):
              rounds, accept
              rate, tok/s, launches held exactly from the rounds and draft
              steps, and a profile of a 4-token run (device ms a round).
              Traffic T: the speculative slot pool
              (``serve/spec_batch``), 8 slots, 16 requests of 64 seeded
              tokens, 64 new each, greedy, the 8-layer self-draft: steady
              tok/s over up to 16 rounds with all slots busy and no
              admission, launches held exactly each round (K1 208, K3 40),
              host and device ms a round, accept rate, capacity fallbacks.
              Every verify row S's and T's greedy runs used, and every row
              of their verify passes teacher-forced over their streams, is
              held against the plain twins' forward (bf16 and f32) by the
              teacher-forced rule. Their streams are held against the
              plain greedy ``generate`` and ``BatchingEngine`` streams:
              equal, or parting first at a bf16 near tie, judged on the
              rows both paths recorded (each within the rule of the f32
              row, each path's margin between the two tokens within the
              distance between them). One self-draft run of each, in f32
              on the plain path, must equal the plain f32 streams.
              Traffic U: beam search through ``AwqCausalLM.generate``, bs2
              x 64-token prompts, 4 beams, 64 new tokens, all beams
              returned, run once: tok/s, K5 and K3 32 a step held exactly,
              each beam's score against its teacher-forced sum of log-probs
              on the same decode route (within 1e-3 of the sum), that
              route's rows, and those of 8 random continuations, against
              the twins by the rule; the beam search again in f32 on the
              plain path, its scores against the f32 forward's sums
              (within 1e-3). Traffic V: TinyLlama bs1 with
              ``max_seq_len`` 256, a 64-token prompt and 384 new tokens, so
              the cache rolls twice: roll count, tok/s, launches held (K1
              44, K3 22 a step), the step after a roll against the twins.
10. train   — traffic W: LoRA fine-tuning of a quantized 7B.
              Mistral-7B-Instruct-v0.2's config at full width and depth
              (seed-0 W4 g128 weights drawn on the card, unfused), rank-8
              f32 adapters on q, k, v and o, one batch of 4 x 512 seeded
              ids, bf16, AdamW (``train/lora``). One step's launches held
              exactly (K2 224, K4 32, K10 32, K11 32, nothing else), step
              ms (min of 3), training tokens/s, a profile of one step,
              peak memory; 16 AdamW steps with the last loss below the
              first; on the first 2 and the first 16 layers
              (``TRAIN_CHECK_LAYERS``), one step's loss and adapter
              gradients (B drawn nonzero) against the plain route in bf16
              and f32 by the teacher-forced style rule.
              Traffic X: Mixtral-8x7B at full width, ``MIXTRAL_DEPTH`` (2)
              of 32 layers (seed-0 W4 g128 weights drawn on the card,
              experts stacked, attention unfused), rank-8 adapters on q /
              k / v / o; traffic Y: DeepSeek-V2-Lite at full width,
              ``V2_LITE_DEPTH`` (5) of 27 layers, g64, adapters on q_proj,
              kv_b_proj and o_proj; both W's batch, bf16, AdamW. Each
              expert runs on its routed rows (K1 below 256, K2 from
              there). (c) One step's launches held exactly against those
              its recorded routing implies, step ms (min of 3), tokens/s,
              a profile, peak memory; (b) 8 steps, the last loss below
              the first; (a) on the first 2 layers one step's loss and
              gradients against the plain route in bf16 and f32, the
              plain runs replaying the kernel route's expert choice (flip
              shares reported and held); Y's (d): a greedy decode through
              the latent cache with the trained kv_b adapter, held
              teacher-forced against the materialized forward by the e2e
              rule, and its f32 latent decode within 1e-3 of the f32
              forward. Then K2 at X's expert shapes (M = 512) and K1 at
              Y's (M = 192), timed with bounds and library calls.
11. parallel — tensor, expert and data parallelism on torch.distributed.
              (a) A world of one over NCCL in this process: TinyLlama at
              full width and depth (seed 0, fused) through
              ``shard(build_mesh(tensor=1))``: an all-reduce is the
              identity, the tree unchanged, A's step (bs1 x 64) and C's
              shape (bs8 x 64) give the unsharded port's greedy streams
              exactly (16 tokens) and A's and C's launches a step. (b) Two
              ranks spawned on the one card over gloo (NCCL refuses two
              ranks on one device; the port stages gloo's collectives on
              CUDA tensors through host memory), each printing its step
              ms with the backend: TinyLlama at full width and depth at
              tensor 2, a 2 x 384 prefill (K2, K4 on the rank's heads), a
              bs8 x 64 prefill with ``PARALLEL_DECODE_STEPS`` decode steps
              (K5, K8 a layer) and A's bs1 x 64 with as many (K1 on q, k,
              v and o's row shard, K8), launches a rank held exactly,
              logits held against the unsharded port's f32 plain path by
              the teacher-forced rule; the slot engine on H's requests (16
              x 64 tokens, 64 new: H's 128 cut) at
              ``PARALLEL_ENGINE_LAYERS`` (16) layers against the unsharded
              engine, streams equal or
              parting only at a bf16 near tie; Mixtral-8x7B at full
              width, ``PARALLEL_MIXTRAL_LAYERS`` (2) layers, expert 2, E's
              bs1 step and F's 8 x 512 prefill under both dispatch
              schemes with the f32 run's expert choice replayed, held by
              the rule and beside the world of one's kernel path, launches
              held; data-parallel AWQ calibration of TinyLlama at full
              width, 2 layers, data 2 against one process on 16 x 512
              seeded ids (clip search off and on, the CPU tests' bounds on
              scales and the tree; with it off the logits within 5e-3 +
              5e-3 max |logit|, with it on the tree's close share alone).
              Sequence parallelism at tensor 2 (``forward(...,
              sequence_parallel=)``): TinyLlama at full width,
              ``PARALLEL_SP_LAYERS`` (2) layers, a 2 x 384 and a 2 x 383
              prompt, launches and staged collectives (all-gathers,
              reduce-scatters, all-reduces) held exactly, logits held
              against the unsharded f32 plain path by the rule, host ms
              reported as not a speed.
              Then K1, K2, K5, K6 and K8 against their twins at a rank's
              shapes (tensor 2: TinyLlama; expert 2: Mixtral's 4 experts
              a rank), timed with bounds and library calls.
12. pipeline — GPipe stages (``parallel/pipeline.py``), with tensor
              parallelism inside them. (a) A world of one over NCCL in
              this process: TinyLlama at full width and depth,
              ``pipeline_forward`` (fused) and ``pipeline_lora_step``
              (unfused, adapters on q / k / v / o) at pipe 1 over 4
              microbatches of 1 x 384 beside ``forward`` and
              ``lora_train_step``, each held against the plain f32 run.
              (b) Two gloo ranks: Mistral-7B at full width,
              ``PIPELINE_DEPTH`` (8) layers, pipe 2, W's 4 x 512 ids in 4
              microbatches, rank-8 f32 adapters on q / k / v / o: the
              forward's logits by the teacher-forced rule and one LoRA
              step's loss and updates by W's rule, against the world of
              one's plain runs; launches a stage held exactly (K2, K4;
              K10, K11 in the step); host ms a step. (c) Four gloo ranks:
              TinyLlama at full width and depth, pipe 2 x tensor 2, B's 2 x
              384 in 2 microbatches, adapters on q / v / o / down, held as
              (b). (d) The same four ranks at full width and
              ``PIPELINE_BREADTH_DEPTH`` (2) layers: MPT-7B (ALiBi) and
              DeepSeek-V2-Lite (both layers MoE) at pipe 2 x tensor 2 over
              2 x 256, then flat tensor 2 with a 1 x 64 prefill and
              ``PARALLEL_DECODE_STEPS`` teacher-forced decode steps (MPT on
              K1; V2-Lite's absorbed decode on the rank's heads, K6, K8),
              V2-Lite's f32 expert choice replayed. Then K2 at Mistral's
              unfused linears at M = 512 and K1 at an MPT-7B rank's under
              tensor 2, timed with bounds and library calls.
13. multimodal — vision-language models (seeded W4 g128 language models
              with zero points and float bf16 towers drawn on the card,
              seeded pixels). Traffic Q: LLaVA-1.5-7B
              (``llava-hf/llava-1.5-7b-hf``'s config: CLIP ViT-L/14-336 at
              full depth, the GELU projector, Llama-2-7B at
              ``LLAVA_DEPTH`` (4) of 32 layers, fused). (a)
              ``AwqLlavaModel.generate`` on one 336 x 336 image: 4 text +
              576 image + 20 text tokens at bs1, 64 greedy new tokens;
              launches held exactly (a prefill K2 4 and K4 1 a layer; a
              decode step K1 2 and K3 1 a layer) and the teacher-forced
              rule over 8 steps from
              the prompt's embeds (the f32 run's embeds from the tower in
              f32). (b) The paged engine (H's pool with 11 pages a slot)
              over four ``prompt_embeds`` requests, two sharing the image
              and its text prefix: prefix hits held (1, 9 pages), a step's
              launches held (K7 1, K1 2, K3 1 a layer), each stream equal to
              ``generate``'s for its prompt or parting at a bf16 near tie
              of the f32 twin. Traffic Z: Qwen2-VL-7B-Instruct
              (``Qwen/Qwen2-VL-7B-Instruct``'s config, qkv bias, M-RoPE;
              the tower at full depth, the language model at
              ``QWEN_VL_DEPTH`` (2) of 28 layers). (a)
              ``AwqQwen2VLModel.__call__`` on one 448 x 448 image (grid 1 x
              32 x 32: 256 image rows of 296), K2 4 a layer held, logits by
              the rule against the plain path; (b) image-conditioned AWQ of 1
              layer at full width on 8 such prompts (``calib_patches``):
              seconds by part, peak memory, AWQ's mean KL at or below
              RTN's on 2 held-out image prompts, then ``save_quantized`` /
              ``from_quantized`` with logits equal to the in-memory
              model's. Then K2 at both models' linears (M = 600 and 296),
              K4 at Q's prefill, K1 and K3 at Llama-2-7B's decode.
14. omni    — traffic AU: Qwen2.5-Omni-7B's speech path
              (``Qwen/Qwen2.5-Omni-7B``'s config; the thinker W4 g128 at
              ``OMNI_DEPTH`` (4) of 28 layers, fused, with qkv bias; the
              audio tower (f32), the talker (bf16), the DiT and BigVGAN
              (f32) at full depth, drawn on the card by
              ``synth_omni_on_card`` under their checkpoint names). (a) The
              audio tower on 10 s of seeded mel (128 x 1,000: 5 chunks, 250
              embeds) spliced between 16 + 16 text rows (282 rows, text
              positions) through ``generate(prompt_embeds=...)``, 32 new
              tokens: launches held exactly (a prefill K2 16, K4 0 while
              the config's switched-off window is read as a window, else
              4; a decode step K1 8, K3 4), the teacher-forced rule over 8
              steps, a profile of 8 decode steps. (b) ``OmniTalker.
              generate_codec`` on the prompt's embeds and the 32 reply
              tokens' embeds, 64 codec tokens in bf16: K4 24 and nothing
              else, the codec logits by the rule against the f32 plain path
              over 40 teacher-forced steps (the reply's last row repeats
              past 32). (c) ``token2wav`` on the 64 codes as they are
              (a code past the DiT's table reads its last row), 10 RK4
              steps, guidance 0.5, seeded reference
              mel, speaker embedding and noise: 128 mel frames, 30,720
              samples, finite and within [-1, 1]; the first RK4 evaluation's
              DiT forward on 24 codes and the vocoder on 32 of the card's
              mel frames held against an f64 run on the CPU: the card's f32
              (TF32 off in token2wav's scope) within ``OMNI_F64_RULE`` (10)
              times the CPU's f32 distance from it, +1e-6 of the scale; a
              control of the vocoder with TF32 on, reported. Seconds by
              part and peak memory.
15. tools   — TinyLlama (traffic A's seeded weights) saved, then ``python
              -m autoawq_tpu_torch benchmark --model DIR --contexts 64
              --decode 32`` in a subprocess on the card, its tok/s line
              printed; ``utils/profiling.trace`` over 8 of A's decode
              steps, ``summarize_trace``'s K1 and K3 device kernels
              (``DenseJob``; ``ActOut`` + ``DownJob``, two a K3 call)
              against the launch counter; ``eval/tasks.eval_multiple_choice``
              on 4 seeded 4-choice questions with a character-level stub
              tokenizer, the log-prob rows behind each choice's
              log-likelihood by the rule against the plain path (bf16 and
              f32).
16. examples — the port's examples and scripts (``examples/torch_*.py``,
              ``scripts/torch_*.py``), each ``main`` called in-process at
              TinyLlama-1.1B's full width and depth with a stand-in
              tokenizer (one id a character): ``make_artifact`` (the
              seeded float model of its ``RECIPE``, calibration sampled
              from it, AWQ, the checkpoint the examples load; the float
              model saved beside it, whole and cut to
              ``EXAMPLES_QUANT_LAYERS`` (2) layers), ``generate`` (a
              300-id prompt: K2 7 and K4 1 a layer; 15 decode steps on the
              checkpoint's unfused layout: K1 4 and K8 1 a layer; 8 steps
              teacher-forced by the rule), ``benchmark --synthetic
              tinyllama`` (two bs1 rounds: K1, K3), then ``benchmark
              --model`` on the artifact (fused at load) at ``--batch-size
              8`` (K2 in the prompt, K5 and K3 a step), ``eval --task
              kldiv`` against the float model on 2 x 256 seeded ids (K2,
              K4), ``serve`` (8 requests on the slot pool of 8, 16 new
              each: K1 4 and K8 1 a layer a step), ``server --paged`` (one
              SSE request of 64 ids, 8 new: K1, K7, K8 a step), ``train``
              (3 AdamW LoRA steps at 4 x 512 on seeded synthetic-language
              ids: K2 7, K4, K10, K11 a layer a step), ``quantize`` on the
              cut float model (16 x 256 seeded ids), ``quality`` in
              artifact mode on the checkpoint ``make_artifact`` built (AWQ's
              Δppl below RTN's), ``quality`` in trained mode (the gate: fp
              ppl < 100, AWQ's Δppl within 10% of it and below RTN's) and
              ``kbench`` at M = 1 and 256. Every
              logged call's launches (prefill, decode step, pool step,
              paged step, training step, forward) are held exactly
              against what its arguments imply by the routing rules
              (``_forward_launches``), their sum against the call's, and
              the call's device kernels read by ``utils/profiling.
              device_kernels`` against the launch counter;
              seconds by example, the gate's figures and the training
              losses printed with the card's name and power limit.
17. a ``kernels`` line: every ported kernel with launches, error and times
   (the mla_moe phase's K6 and K8 rows after the eleven, then the train,
   multimodal and kernels phases' rows at their models' shapes). The
   kernels phase also holds and times K1 at Qwen2.5-Omni's thinker qkv
   3584→4608 and o 3584→3584 (M = 1), K3 at 3584→2·18944→3584 (M = 1)
   and K4 at the talker's prompt (B = 1, S = 282, 12 / 4 heads x 128).

Asked for by name only, each for an A/B of two checkouts in one call
(``--root DIR`` imports the port, and builds its kernels, from another
checkout, such as a parent commit unpacked with ``git archive``):
``prefill`` — K2 and K4 at B's and D's prefill shapes and traffic B's and
D's prefill seconds; ``paged`` — K7 at H's and I's shapes, K9 at J's, both
on a long table (8 slots of 4096 rows), and H's, I's and J's device ms a
decode step with K7's or K9's profile rows; ``linears`` — K1 at
TinyLlama's and Mistral's linears (M = 1, 8, 64, 255), K6 at E's and F's
decode and prefill shapes, controls K2, K3 and K8, and A's, H's, E's and
F's device ms a decode step and F's prefill seconds with K1's and K6's
profile rows; ``decode_mlp_attn`` — K3 at TinyLlama's and Mistral's and
K8 at TinyLlama's and a Mixtral expert's decode MLP (beside the unfused
chain on K1), K5 at C's and D's last decode step, controls K1, K2, K6, K7
and K9, and A's, G's, C's, D's and H's device ms a decode step with K3's,
K5's and K8's profile rows; ``attn_bwd`` — K10 and K11 at W's,
TinyLlama's and GPT-J's hd 256 shapes (held and timed with their bounds)
and W's step ms on W's weights.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without it. Without a CUDA device, or outside a checkout of the
repo, the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "e2e", "load", "quantize", "zoo",
          "mla_moe", "serve", "train", "parallel", "pipeline", "multimodal",
          "omni", "tools", "examples")
EXTRA_PHASES = ("prefill", "paged", "linears", "decode_mlp_attn",
                "attn_bwd")  # asked for by name only
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
L2_BYTES = 50 * 1024 * 1024
# TinyLlama-1.1B (bench.py's headline configuration)
TINYLLAMA = dict(model_type="llama", vocab_size=32000, hidden_size=2048,
                 intermediate_size=5632, num_hidden_layers=22,
                 num_attention_heads=32, num_key_value_heads=4, head_dim=64,
                 max_position_embeddings=2048)
# Mistral-7B-Instruct-v0.2's published config.json (sliding_window null)
MISTRAL = dict(model_type="mistral", vocab_size=32000, hidden_size=4096,
               intermediate_size=14336, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=8, head_dim=128,
               max_position_embeddings=32768, rope_theta=1e6,
               sliding_window=None)
# Mixtral-8x7B-Instruct-v0.1's published config.json
MIXTRAL = dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
               intermediate_size=14336, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=8, head_dim=128,
               num_experts=8, num_experts_per_tok=2, rope_theta=1e6,
               rms_norm_eps=1e-5, max_position_embeddings=32768,
               sliding_window=None)
# the decoder zoo's published config.json values (HF keys, read by
# ModelConfig.from_hf_dict). mosaicml/mpt-7b: ALiBi, LayerNorm without
# bias, gelu, tied embeddings
MPT7B = dict(model_type="mpt", d_model=4096, n_layers=32, n_heads=32,
             expansion_ratio=4, vocab_size=50432, max_seq_len=2048,
             no_bias=True, attn_config={"alibi": True})
# google/gemma-2-9b
GEMMA2_9B = dict(model_type="gemma2", hidden_size=3584,
                 intermediate_size=14336, num_hidden_layers=42,
                 num_attention_heads=16, num_key_value_heads=8, head_dim=256,
                 vocab_size=256000, query_pre_attn_scalar=256,
                 attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                 sliding_window=4096, hidden_activation="gelu_pytorch_tanh",
                 rms_norm_eps=1e-6, max_position_embeddings=8192,
                 tie_word_embeddings=True)
# Qwen/Qwen3-8B
QWEN3_8B = dict(model_type="qwen3", hidden_size=4096, intermediate_size=12288,
                num_hidden_layers=36, num_attention_heads=32,
                num_key_value_heads=8, head_dim=128, vocab_size=151936,
                rope_theta=1e6, rms_norm_eps=1e-6,
                max_position_embeddings=40960, tie_word_embeddings=False)
# EleutherAI/gpt-j-6b (n_inner null: 4 x n_embd)
GPTJ_6B = dict(model_type="gptj", n_embd=4096, n_layer=28, n_head=16,
               rotary_dim=64, n_inner=None, vocab_size=50400,
               n_positions=2048, activation_function="gelu_new",
               layer_norm_epsilon=1e-5, tie_word_embeddings=False)
# deepseek-ai/DeepSeek-V2-Lite: MLA (q_lora_rank null), 64 routed experts
# top-6 and 2 shared, layer 0 dense, yarn rope
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
    intermediate_size=10944, moe_intermediate_size=1408,
    num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
    n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
    first_k_dense_replace=1, moe_layer_freq=1, n_group=1, topk_group=1,
    topk_method="greedy", scoring_func="softmax", norm_topk_prob=False,
    routed_scaling_factor=1.0, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    hidden_act="silu", rms_norm_eps=1e-6, rope_theta=10000,
    max_position_embeddings=163840, tie_word_embeddings=False,
    rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32,
                  "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                  "original_max_position_embeddings": 4096})
# deepseek-ai/DeepSeek-V3: sigmoid scores, noaux_tc over 8 groups (top 4)
# with the router's e_score_correction_bias, q_lora, 256 experts top-8
DEEPSEEK_V3 = dict(
    model_type="deepseek_v3", vocab_size=129280, hidden_size=7168,
    intermediate_size=18432, moe_intermediate_size=2048,
    num_hidden_layers=61, num_attention_heads=128, num_key_value_heads=128,
    n_routed_experts=256, n_shared_experts=1, num_experts_per_tok=8,
    first_k_dense_replace=3, moe_layer_freq=1, n_group=8, topk_group=4,
    topk_method="noaux_tc", scoring_func="sigmoid", norm_topk_prob=True,
    routed_scaling_factor=2.5, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    hidden_act="silu", rms_norm_eps=1e-6, rope_theta=10000,
    max_position_embeddings=163840, tie_word_embeddings=False,
    rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32,
                  "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 1.0,
                  "original_max_position_embeddings": 4096})
# Qwen/Qwen3-30B-A3B: 128 experts top-8, norm_topk_prob, q/k norms, GQA
QWEN3_30B_A3B = dict(
    model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
    intermediate_size=6144, moe_intermediate_size=768, num_hidden_layers=48,
    num_attention_heads=32, num_key_value_heads=4, head_dim=128,
    num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
    decoder_sparse_step=1, mlp_only_layers=[], hidden_act="silu",
    rms_norm_eps=1e-6, rope_theta=1e6, max_position_embeddings=40960,
    tie_word_embeddings=False)
# V2-Lite's dense MLP is 10,944 wide, 85.5 groups of 128: a g128 AutoAWQ
# checkpoint cannot hold it unpadded, and the port's loader and K3 take no
# K pad, so the model is drawn at g64 (AutoAWQ quantizes a model at one
# group size); V3 and Qwen3-MoE at g128
MLA_MOE_GS = 64
# DeepSeek-V3 and Qwen3-30B-A3B at published width, depth cut to 2 (V3:
# first_k_dense_replace cut from 3 to 1, so one dense and one MoE layer)
MLA_MOE_CUT_DEPTH = 2
ZOO_DEPTH = 2  # Gemma-2, Qwen3 and GPT-J at published width, depth cut
# Mixtral's traffics E, F and X at published width, depth cut to a
# sixteenth: with the zoo, mla_moe, serve and train phases the script
# would otherwise run past its time limit (16 layers took ~63 s more than
# 8, and 8 ~50 s more than 4; 4 to 2 when traffics X and Y came and a
# whole run on a slow host took 1,150 s)
MIXTRAL_DEPTH = 2
# The long generation of A's, G's and L's decode quotient (new tokens,
# cut from 512, then from 256 when the parallel phase came) and the depth
# of Mistral-7B in the e2e phase's traffics C, D, H, I, J and K (8 of its
# 32 layers: 16 until the pipeline phase came), and DeepSeek-V2-Lite's in
# the mla_moe phase's O, P and R and the train phase's Y (5 of its 27:
# layer 0 dense, 4 MoE; 9 until traffics X and Y came): cut to keep the
# script within its time limit on slower hosts, where these host-bound
# decode loops take most of its time.
DECODE_BIG = 128
E2E_MISTRAL_DEPTH = 8
V2_LITE_DEPTH = 5
# AWQ calibration of the quantize phase: AutoAWQ's recipe (g128 with zero
# points) on 64 seeded samples of 512 tokens, half its default 128 (cut for
# the time limit when the omni and tools phases came); 8 x 512 held-out
# tokens sampled from the float model for the quality gate
QUANT_CALIB = (64, 512)
QUANT_EVAL = (8, 512)
QUANT_MISTRAL_LAYERS = 1  # Mistral-7B at full width, depth cut to 1 of 32
# MPT-7B at full width, depth cut to 1 of 32 (at 2, with the serve phase,
# the whole script ran past its 1,200 s limit on an H100)
QUANT_MPT_LAYERS = 1
QUANT_GPTJ_LAYERS = 1  # GPT-J-6B at full width, depth cut to 1 of 28
# DeepSeek-V2-Lite quantized at full width, depth cut to 2 of 27 (layer 0
# dense, layer 1 MoE), calibrated on 32 x 512 of AutoAWQ's 128 x 512: the
# dense moe inspect runs all 64 experts on every token, ~18 TFLOP of f32 a
# grid point at 16k tokens (~72 at 65k)
V2_LITE_QUANT_LAYERS = 2
V2_LITE_CALIB = (32, 512)
# speculative decoding of the serve phase: k proposals a round, and the
# self-draft's depth (the target's first 8 of 32 layers)
SPEC_K = 4
SPEC_DRAFT_LAYERS = 8
LINEARS = {"qkv": (2048, 2560), "o": (2048, 2048), "gate_up": (2048, 11264),
           "down": (5632, 2048)}
# Mistral-7B's four linears (fused qkv and gate_up) at traffic D's prefill,
# M = 8 x 2048 rows, and K4 at D's shape (B, S, nh, nkv, hd)
D_LINEARS = {"qkv": (4096, 6144), "o": (4096, 4096),
             "gate_up": (4096, 28672), "down": (14336, 4096)}
D_M = 8 * 2048
D_ATTN = (8, 2048, 32, 8, 128)
# traffic W: LoRA fine-tuning of Mistral-7B (W4 g128, unfused, 32 layers),
# rank-8 f32 adapters on q/k/v/o, 4 x 512 seeded ids a step, bf16; 16
# AdamW steps on one batch. The gradient check against the plain route
# runs on the first 2 and the first 16 layers: the f32 plain step keeps
# every layer's dequantized f32 weights and f32 scores for its backward,
# ~2.1 GB a layer, and at 16 random layers both bf16 routes' gradients sit
# ~1 (relative L2) from f32 (bf16 rounding, amplified: the logits of
# Mistral's random layers move by 0.15-0.74 of their scale), where 2
# layers leave the rule room to catch a kernel's error
TRAIN_BATCH = (4, 512)
TRAIN_RANK = 8
TRAIN_STEPS = 16
TRAIN_LR = 1e-3
TRAIN_CHECK_LAYERS = (2, 16)
TRAIN_ATTN = (4, 512, 32, 8, 128)  # K4 / K10 / K11 at W's step
TRAIN_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")
# traffics X (Mixtral-8x7B at MIXTRAL_DEPTH layers, experts stacked,
# attention unfused) and Y (DeepSeek-V2-Lite at V2_LITE_DEPTH layers, g64,
# adapters on q, kv_b and o): W's batch, rank and learning rate, 8 AdamW
# steps, the gradient check on the first 2 layers; Y's (d) a greedy decode
# of 4 steps after a 2 x 64 prompt through the latent cache
TRAIN_MOE_STEPS = 8
TRAIN_MOE_CHECK_LAYERS = 2
V2_LITE_TRAIN_TARGETS = ("q_proj", "kv_b_proj", "o_proj")
TRAIN_FOLD = (2, 64, 4)
BACKWARD_KERNELS = ("prefill_attention_dkv", "prefill_attention_dq")
KERNEL_META = {
    "w4a16_gemv": ("autoawq_tpu_torch/csrc/w4a16_gemv.cu",
                   "autoawq_tpu/ops/pallas_gemm.py:98"),
    "w4a16_gemm": ("autoawq_tpu_torch/csrc/w4a16_gemm.cu",
                   "autoawq_tpu/ops/pallas_gemm.py:146"),
    "fused_mlp": ("autoawq_tpu_torch/csrc/fused_mlp.cu",
                  "autoawq_tpu/ops/fused_mlp.py:81"),
    "prefill_attention": ("autoawq_tpu_torch/csrc/prefill_attention.cu",
                          "autoawq_tpu/nn/modules.py:338"),
    "fused_attn_step": ("autoawq_tpu_torch/csrc/fused_attn_step.cu",
                        "autoawq_tpu/ops/fused_attn_step.py:54"),
    "moe_gemm": ("autoawq_tpu_torch/csrc/moe_gemm.cu",
                 "autoawq_tpu/ops/moe_gemm.py:88"),
    "fused_mlp3": ("autoawq_tpu_torch/csrc/fused_mlp3.cu",
                   "autoawq_tpu/ops/sharded_mlp.py:45"),
    "paged_attn": ("autoawq_tpu_torch/csrc/paged_attn.cu",
                   "autoawq_tpu/ops/paged_attn.py:40"),
    "paged_attn_stock": ("autoawq_tpu_torch/csrc/paged_attn_stock.cu",
                         "autoawq_tpu/nn/modules.py:459"),
    # jax's stock backward kernels of the flash attention K4 replaces
    # (jax 0.9.0), which the JAX package runs when it trains
    "prefill_attention_dkv": (
        "autoawq_tpu_torch/csrc/prefill_attention_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "prefill_attention_dq": (
        "autoawq_tpu_torch/csrc/prefill_attention_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
}
# tolerances, as max |kernel - twin| / max |twin| on the same inputs:
# K1 keeps q - z exact and scales each group's f32 sum once, where the twin
# rounds (q - z) * s to bf16 first; both round the output to bf16, and the
# sums run in another order: ~1e-2 covers a few bf16 ulps of the output's
# scale. K2 rounds weights exactly
# like the twin; K3 keeps g and u in f32 where the twin rounds both.
# K4 is held per query row and head, as max over rows of max |diff_row| /
# max |twin_row|: a causal output's scale falls from |v| in row 0 to about
# sqrt(1/i) in row i, so one global maximum would hide a wrong late row or
# a dropped key tile. Both sides round the row to bf16, so a sound kernel
# can differ by one bf16 ulp of the row's largest value (up to 2^-7 of it,
# which the H100 reads); the limit is two such ulps, 2^-6.
# K5's y is held per batch row (max |diff_row| / max |twin_row|): both
# sides round the attention output and y to bf16 after f32 sums taken in
# other orders, so y can differ by one bf16 ulp of the row maximum (up to
# 2^-7) plus what a flipped rounding of the attention output carries
# through the o product; the limit is two ulps, 2^-6, as K4's (the H100
# read at most 0.0057 over two runs of six shapes, against a first limit
# of 2e-2). k_new / v_new are held per head row at 2^-7: both sides round
# f32 rows equal to ~1e-6 to bf16, at most one ulp of the row maximum
# apart (the H100 read at most 0.0031), and keep them in f32 for an int8
# cache.
# K6 is held per call over all its rows (the trailing dead blocks are zero
# on both sides) at 1e-2: K1's arithmetic for blocks of 8 rows, K2's for
# larger ones. K8 and moe_mlp at 2e-2, as K3: each holds two products and
# an activation. Mixtral's MoE block on a layer's real hidden state
# (moe_block: router, moe_align, two K6 calls, the combine) is held against
# a dense f32 reference at 2e-2 of its maximum, moe_mlp's limit: bf16
# rounds g, act(g)*u and the expert outputs, as the bf16 twin does.
# K7 and K9 are held per (slot, query head) row. K7 returns f32 and its twin
# computes the same f32 function (one softmax where K7 runs online ones
# over splits and merges them), so they differ by the order of sums over up
# to 4096 rows and, on the tensor cores, by the ~2^-17 residual of q and p
# split into bf16 hi + lo parts: 1e-4 of the row maximum (the H100 reads
# ~5e-6). K9 returns bf16
# and, with a group of 8 query heads, rounds its running output to bf16
# after every block of pages as the stock kernel does: two bf16 ulps of the
# row maximum, 2^-6, as K4's and K5's limit.
# K10 and K11 are held per gradient tensor (dq; dk and dv), as
# max |kernel - twin| / max |twin|: both round P and dS (the twin its
# probabilities and the gradients at its bf16 casts) to bf16 and sum in f32
# in other orders, and dS = P (dP - D) cancels where dP is near D, so a
# sound kernel differs by a few bf16 ulps of the tensor's scale (the H100
# read at most 0.0067 over six shapes in a first run); the limit is 2e-2.
# Traffic W's gradients are held by the teacher-forced style rule: each
# adapter gradient's relative L2 distance from an f32 plain step within
# twice the bf16 plain step's plus a floor of 1e-2 (about 2.5 bf16 ulps of
# rounding carried through the layers); the same for the loss. Traffic Y's
# LLaVA-1.5-7B: llava-hf/llava-1.5-7b-hf's config.json (CLIP ViT-L/14-336,
# the 1024 -> 4096 -> 4096 GELU projector, Llama-2-7B)
LLAVA_15_7B = dict(
    model_type="llava", image_token_index=32000, projector_hidden_act="gelu",
    vision_feature_layer=-2, vision_feature_select_strategy="default",
    text_config=dict(model_type="llama", vocab_size=32064, hidden_size=4096,
                     intermediate_size=11008, num_hidden_layers=32,
                     num_attention_heads=32, num_key_value_heads=32,
                     max_position_embeddings=4096, rms_norm_eps=1e-5,
                     rope_theta=10000.0),
    vision_config=dict(model_type="clip_vision_model", hidden_size=1024,
                       intermediate_size=4096, num_hidden_layers=24,
                       num_attention_heads=16, patch_size=14, image_size=336,
                       hidden_act="quick_gelu", layer_norm_eps=1e-5,
                       projection_dim=768))
# Qwen2-VL-7B-Instruct: Qwen/Qwen2-VL-7B-Instruct's config.json
QWEN2_VL_7B = dict(
    model_type="qwen2_vl", vocab_size=152064, hidden_size=3584,
    intermediate_size=18944, num_hidden_layers=28, num_attention_heads=28,
    num_key_value_heads=4, hidden_act="silu", max_position_embeddings=32768,
    rms_norm_eps=1e-6, rope_theta=1e6, sliding_window=32768,
    use_sliding_window=False, max_window_layers=28, tie_word_embeddings=False,
    image_token_id=151655, video_token_id=151656,
    vision_start_token_id=151652,
    rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
    vision_config=dict(depth=32, embed_dim=1280, hidden_size=3584,
                       num_heads=16, mlp_ratio=4, patch_size=14,
                       temporal_patch_size=2, spatial_merge_size=2,
                       in_chans=3, hidden_act="quick_gelu"))
# the multimodal phase's cuts: the language models' depth (the towers run
# at full depth), as Mistral's e2e traffics are cut
LLAVA_DEPTH = 4  # 8 until the omni phase came (a cut for time)
QWEN_VL_DEPTH = 2  # 4 until then
QWEN_VL_QUANT_LAYERS = 1  # Z's image-conditioned AWQ, the quantize cuts'
LLAVA_PROMPT = (4, 20)  # text tokens before and after Q's 576 image tokens
LLAVA_NEW = 64
LLAVA_TF_STEPS = 8
QWEN_VL_GRID = (1, 32, 32)  # one 448 x 448 image: 1,024 patches, 256 rows
QWEN_VL_TEXT = (14, 24)  # text around <|vision_start|> image <|vision_end|>
QWEN_VL_CALIB = 8  # Z's image-conditioned calibration samples
# Qwen2.5-Omni-7B: Qwen/Qwen2.5-Omni-7B's config.json. The thinker's text
# model has Qwen2.5-VL-7B's widths and carries the checkpoint's window of
# 32768 with use_sliding_window false, which both packages read as a window
# (ROADMAP §3), so its prompt skips K4; the audio tower, the DiT and
# BigVGAN equal transformers 4.57.6's defaults; the talker is the
# checkpoint's (896 wide, 24 layers, 12 / 4 heads x 128, embedding_size
# 3584), not transformers' default talker (3584 wide, 28 layers)
QWEN25_OMNI_7B = dict(
    model_type="qwen2_5_omni",
    thinker_config=dict(
        audio_token_index=151646,
        text_config=dict(
            model_type="qwen2_5_omni_text", vocab_size=152064,
            hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
            num_attention_heads=28, num_key_value_heads=4, hidden_act="silu",
            max_position_embeddings=32768, rms_norm_eps=1e-6,
            rope_theta=1e6, sliding_window=32768, use_sliding_window=False,
            max_window_layers=28, tie_word_embeddings=False,
            rope_scaling={"type": "default", "rope_type": "default",
                          "mrope_section": [16, 24, 24]}),
        audio_config=dict(d_model=1280, encoder_layers=32,
                          encoder_attention_heads=20, encoder_ffn_dim=5120,
                          num_mel_bins=128, n_window=100, output_dim=3584,
                          max_source_positions=1500)),
    talker_config=dict(
        vocab_size=8448, hidden_size=896, intermediate_size=18944,
        num_hidden_layers=24, num_attention_heads=12, num_key_value_heads=4,
        head_dim=128, embedding_size=3584, hidden_act="silu",
        max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=1e6,
        sliding_window=32768, use_sliding_window=False),
    token2wav_config=dict(
        dit_config=dict(
            hidden_size=1024, num_hidden_layers=22, num_attention_heads=16,
            head_dim=64, ff_mult=2, emb_dim=512, enc_emb_dim=192,
            enc_dim=128, enc_channels=[256, 256, 256, 256, 768],
            enc_kernel_sizes=[5, 3, 3, 3, 1], enc_dilations=[1, 2, 3, 4, 1],
            enc_attention_channels=64, enc_res2net_scale=2,
            enc_se_channels=64, mel_dim=80, num_embeds=8193, repeats=2,
            block_size=24, look_ahead_layers=[10],
            look_backward_layers=[0, 20], rope_theta=10000.0),
        bigvgan_config=dict(
            mel_dim=80, upsample_initial_channel=1536,
            resblock_kernel_sizes=[3, 7, 11],
            resblock_dilation_sizes=[[1, 3, 5]] * 3,
            upsample_rates=[5, 3, 2, 2, 2, 2],
            upsample_kernel_sizes=[11, 7, 4, 4, 4, 4])))
OMNI_DEPTH = 4  # the thinker's layers (of 28), Z's cut; the rest full depth
OMNI_MEL = 1000  # 10 s of mel frames: 5 chunks of 200, 250 audio embeds
OMNI_TEXT = (16, 16)  # text rows before and after the audio embeds
OMNI_NEW = 32  # the thinker's reply tokens
OMNI_TF_STEPS = 8  # the thinker's teacher-forced decode steps
OMNI_CODES = 64  # the talker's codec tokens
OMNI_TALKER_TF = 40  # the talker's teacher-forced steps (past the 32 reply
#                      rows, where the last one repeats)
OMNI_T2W = dict(num_steps=10, guidance_scale=0.5, sway_coefficient=-1.0)
OMNI_REF_FRAMES = 300  # the seeded reference mel's frames
OMNI_VOCODER_CHECK = 32  # mel frames of the vocoder's check on the CPU
OMNI_DIT_CHECK = 24  # codes (48 frames, two blocks) of the DiT's check
# token2wav's card runs (f32, TF32 off) within this many times the CPU's f32
# distance from an f64 run: cuDNN's f32 convolution algorithms sit 2-3.5x
# the CPU's distance at the vocoder (PyTorch's own convolutions 0.7-1.2x;
# ``scripts/torch_vocoder_f32.py``), the DiT's matmuls under 1x, and the
# vocoder with TF32 on ~700x (the phase's control)
OMNI_F64_RULE = 10
TOOLS_MMLU = 4  # seeded 4-choice questions of the tools phase
TOOLS_TIMEOUT = 300  # seconds the CLI's benchmark subprocess may take
# f32 latent decode (the absorbed kv_b with its adapter folded) is held
# against the f32 materialized forward at 1e-3 of the logit scale: the two
# differ by f32 summation order alone (the CPU tests read ~1e-6), while a
# dropped kv_b adapter moves the logits by ~1 of their scale there.
TOL = {"w4a16_gemv": 1e-2, "w4a16_gemm": 1e-2, "fused_mlp": 2e-2,
       "prefill_attention": 2 ** -6, "fused_attn_step": 2 ** -6,
       "fused_attn_step_kv": 2 ** -7, "moe_gemm": 1e-2, "moe_mlp": 2e-2,
       "moe_block": 2e-2, "fused_mlp3": 2e-2, "paged_attn": 1e-4,
       "paged_attn_stock": 2 ** -6, "prefill_attention_bwd": 2e-2,
       "train_grad_floor": 1e-2, "mla_fold": 1e-3}
# the paged pools of traffics H-K (CHIP_AB_R5_PAGED.json's pool for H, I
# and J; scripts/bench_serve.py's paged configuration for K)
PAGED_POOL = dict(max_batch=8, page_size=64, pages_per_seq=8,
                  total_pages=136)
SERVE_POOL = dict(max_batch=8, page_size=64, pages_per_seq=7,
                  total_pages=120)
# ragged lengths of the kernels phase's paged cases: 1 (two trash-page
# slots) up to the table's 512 rows
PAGED_LENGTHS = [1, 512, 77, 128, 300, 1, 64, 65]
# the long-table case of K7 and K9: 8 slots of 4096 rows, 64 pages of 64
# a slot (K9 in compute blocks of 8 pages, the engine's choice)
LONG_TABLE = dict(lengths=[4096] * 8, pps=64)

failures = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        emit({"phase": "failure", "what": what})


# ---------------------------------------------------------------- helpers

def time_ms(fn, arg_sets, iters: int, reps: int = 3, graph: bool = True):
    """Device time of one call, in ms: ``iters`` calls cycling through
    ``arg_sets`` (copies of the weights that together exceed the L2 cache,
    so each call streams its weights from device memory, as decode does)
    are captured in a CUDA graph and replayed between CUDA events, so the
    host's per-call overhead does not hide the kernel. Also returns the
    eager time per call (a Python loop between the same events), which is
    what an uncaptured caller pays. ``graph=False`` (a function that reads
    the device on the host, as K6's twin does) returns the eager time
    twice."""
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    if not graph:
        return eager, eager
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / (iters * reps)
    del graph
    return device, eager


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b):
    d = (a.float() - b.float()).abs().max().item()
    return d, d / max(b.float().abs().max().item(), 1e-30)


def row_rel_err(a, b, hd: int) -> float:
    """max over rows of hd values of max |a_row - b_row| / max |b_row|."""
    d = (a.float() - b.float()).reshape(-1, hd).abs().amax(-1)
    r = b.float().reshape(-1, hd).abs().amax(-1).clamp_min(1e-30)
    return (d / r).max().item()


def bf16_order(x):
    """bf16 values as int32 in the order of their values (-0 and +0 both 0),
    so that two values one bf16 ulp apart differ by 1."""
    import torch

    bits = x.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def make_lin(rng, k: int, n: int, gs: int, zp: bool, device):
    import numpy as np
    import torch

    from autoawq_tpu_torch.core.packing import pack_port

    g = k // gs
    lin = {"qweight": pack_port(rng.integers(0, 16, (k, n))).to(device),
           "scales": torch.from_numpy(
               ((rng.random((g, n)) + 0.5) * 0.01).astype(np.float32)
           ).to(device)}
    lin["qzeros"] = (pack_port(rng.integers(0, 16, (g, n))).to(device)
                     if zp else None)
    return lin


def copies(tensors, nbytes: int):
    """Enough clones of ``tensors`` that their bytes exceed twice the L2."""
    n = max(1, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tensors] + [[t.clone() if t is not None else None
                         for t in tensors] for _ in range(n - 1)]


def lin_bytes(lin) -> int:
    return sum(t.numel() * t.element_size() for t in lin.values()
               if t is not None)


# ----------------------------------------------------------------- phases

@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def phase_device():
    import torch

    import autoawq_tpu_torch

    smi = card()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "port": os.path.dirname(os.path.abspath(autoawq_tpu_torch.__file__)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})


def phase_build():
    from autoawq_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    summary = {}
    for name, log in logs.items():
        lines = [ln.strip() for ln in str(log["ptxas"]).splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln
                 or "Performance Loss" in ln]
        summary[name] = {"seconds": round(float(log["seconds"]), 2),
                         "ptxas": lines}
    # K10 and K11 must not spill at hd 64 and 128 (entry lines name the
    # kernel and its head dim; the next line gives its spills)
    bwd = summary.get("prefill_attention_bwd", {}).get("ptxas", [])
    for i, ln in enumerate(bwd):
        if any(f"{k}ILi{hd}E" in ln for k in ("dkv_kernel", "dq_kernel")
               for hd in (64, 128)):
            spill = next((x for x in bwd[i + 1:] if "spill" in x), "")
            check(" 0 bytes spill stores, 0 bytes spill loads" in
                  " " + spill, f"build: {ln.split()[-3]} spills: {spill}")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "kernels": summary})


def _gemm_case(rng, kernel, case, m, k, n, gs, zp, dev, timing=True,
               iters=200, yardsticks=True, plain=True, gen=None):
    """One K1 / K2 call against its twin; with ``timing``, its time over
    ``iters`` calls and (with ``yardsticks``) the library call's (and, with
    ``plain``, the twin's) and the bound. The weight is drawn by ``rng`` on
    the host, or on the card by the torch.Generator ``gen`` where given."""
    import torch

    from autoawq_tpu_torch.ops import gemm
    from autoawq_tpu_torch.utils.synth import synth_qlin

    fn = getattr(gemm, kernel)
    lin = (make_lin(rng, k, n, gs, zp, dev) if gen is None
           else synth_qlin(gen, k, n, gs, zp))
    x = (torch.randn(m, k, device=dev) * 0.5).to(torch.bfloat16)
    args = [x, lin["qweight"], lin["scales"], lin["qzeros"]]
    got = fn(*args)
    ref = gemm.awq_matmul_plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row = {"phase": "kernel", "kernel": kernel, "case": case, "M": m, "K": k,
           "N": n, "gs": gs, "zp": zp, "max_abs_err": err,
           "max_rel_err": rel, "tol": TOL[kernel]}
    check(rel <= TOL[kernel], f"{kernel} {case} M={m} gs={gs} zp={zp}: "
          f"rel err {rel:.3g} > {TOL[kernel]}")
    if timing:
        wb = lin_bytes(lin)
        sets = copies(args, wb)
        row["ms"], row["eager_ms"] = time_ms(fn, sets, iters)
        row["bound_ms"], row["bound_by"] = bound(
            wb + 2 * m * k + 2 * m * n, 2 * m * n * k)
    if timing and yardsticks:
        if plain:
            row["plain_ms"], _ = time_ms(gemm.awq_matmul_plain, sets[:2],
                                         min(iters, 10))
        w = gemm.dequantize(lin["qweight"], lin["scales"], lin["qzeros"],
                            dtype=torch.bfloat16)
        wsets = copies([x, w], w.numel() * 2)
        row["library_ms"], _ = time_ms(torch.matmul, wsets, iters)
        row["library"] = "bf16 torch.matmul on the pre-dequantized weight"
        del w, wsets
    emit(row)
    return row


def _unfused_chain(inter, act, lins):
    """The port's unfused decode MLP on K1 (the yardstick of K3 and K8):
    gate_up (or gate and up), ``act_fn(g) * u`` in PyTorch, down."""
    from autoawq_tpu_torch.ops import fused_mlp as fm
    from autoawq_tpu_torch.ops import gemm

    def run(x, *w):
        if len(lins) == 2:  # fused gate_up
            gu = gemm.w4a16_gemv(x, *w[0:3])
            g, u = gu[:, :inter], gu[:, inter:]
        else:
            g, u = gemm.w4a16_gemv(x, *w[0:3]), gemm.w4a16_gemv(x, *w[3:6])
        return gemm.w4a16_gemv(fm.act_fn(act, g) * u, *w[-3:])
    args = [t for lin in lins for t in (lin["qweight"], lin["scales"],
                                        lin["qzeros"])]
    return run, args


def _mlp_case(rng, m, act, dev, timing=True, h=2048, inter=5632,
              case="TinyLlama", gs=128, gen=None):
    """K3 against its twin at group size ``gs``; with ``timing``, the times
    of K3, the twin and the unfused chain on K1 (``_unfused_chain``) on the
    same weights, and the byte bound. The weights are drawn by ``rng`` on
    the host, or on the card by the torch.Generator ``gen`` where given."""
    import torch

    from autoawq_tpu_torch.ops import fused_mlp as fm
    from autoawq_tpu_torch.utils.synth import synth_qlin

    if gen is None:
        gu = make_lin(rng, h, 2 * inter, gs, True, dev)
        dn = make_lin(rng, inter, h, gs, True, dev)
    else:
        gu = synth_qlin(gen, h, 2 * inter, gs)
        dn = synth_qlin(gen, inter, h, gs)
    x = (torch.randn(m, h, device=dev) * 0.5).to(torch.bfloat16)
    args = [x, gu["qweight"], gu["scales"], dn["qweight"], dn["scales"],
            gu["qzeros"], dn["qzeros"]]

    def run(*a):
        return fm.fused_mlp(*a, inter=inter, act=act)

    def plain(*a):
        return fm.fused_mlp_plain(*a, inter=inter, act=act)

    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row = {"phase": "kernel", "kernel": "fused_mlp",
           "case": f"{case} mlp_{act}", "card": card(), "M": m, "H": h,
           "inter": inter, "gs": gs, "max_abs_err": err, "max_rel_err": rel,
           "tol": TOL["fused_mlp"]}
    check(rel <= TOL["fused_mlp"],
          f"fused_mlp {case} M={m} {act}: rel err {rel:.3g}")
    if timing:
        wb = lin_bytes(gu) + lin_bytes(dn)
        sets = copies(args, wb)
        row["ms"], row["eager_ms"] = time_ms(run, sets, 200)
        row["plain_ms"], _ = time_ms(plain, sets[:2], 10)
        chain, chain_args = _unfused_chain(inter, act, (gu, dn))
        row["unfused_chain_ms"], _ = time_ms(
            chain, copies([x] + chain_args, wb), 200)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = bound(
            wb + 2 * m * h * 2, 2 * m * (h * 2 * inter + inter * h))
    emit(row)
    return row


def _attn_case(b, s, nh, nkv, hd, dev, timing=True, iters=200,
               yardsticks=True, case="prefill"):
    """One K4 call against its twin, held per row; with ``timing``, its
    time over ``iters`` calls and (with ``yardsticks``) the twin's, SDPA's
    and the bound."""
    import torch
    import torch.nn.functional as F

    from autoawq_tpu_torch.ops import attention as at

    q = torch.randn(b, s, nh, hd, device=dev).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=dev).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=dev).to(torch.bfloat16)
    scale = hd ** -0.5
    got = at.prefill_attention(q, k, v, scale)
    ref = at.prefill_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row_rel = row_rel_err(got, ref, hd)
    row = {"phase": "kernel", "kernel": "prefill_attention",
           "case": case, "B": b, "S": s, "nh": nh, "nkv": nkv, "hd": hd,
           "max_abs_err": err, "max_rel_err": rel,
           "max_row_rel_err": row_rel, "tol": TOL["prefill_attention"]}
    check(row_rel <= TOL["prefill_attention"],
          f"prefill_attention B={b} S={s} hd={hd}: per-row rel err "
          f"{row_rel:.3g}")
    if timing:
        args = [[q, k, v, scale]]
        row["ms"], row["eager_ms"] = time_ms(at.prefill_attention, args,
                                             iters)
        flops = 4 * b * nh * hd * (s * (s + 1) / 2)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    if timing and yardsticks:
        row["plain_ms"], _ = time_ms(at.prefill_attention_plain, args,
                                     min(iters, 10))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa(a, b_, c):
            return F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                                  enable_gqa=True)
        row["library_ms"], _ = time_ms(sdpa, [[qt, kt, vt]], iters)
        row["library"] = "torch scaled_dot_product_attention (causal)"
    emit(row)
    return row


def _sdpa_bwd(q, k, v, dout, iters):
    """SDPA's backward (causal, GQA; dq, dk and dv together) as the
    yardstick of K10 + K11, never on the path: the backend pinned with
    ``sdpa_kernel``, flash first, then cuDNN, then memory-efficient, each
    refusal kept; the forward and the backward run on one side stream, so
    that the backward can be captured in a CUDA graph and timed as the
    kernels are (if capture is refused, back-to-back eager calls, which
    keep the device busy at these sizes). Returns (ms, backend, how, the
    backends refused with their errors)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, nh, hd = q.shape
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dsd = dout.view(b, s, nh, hd).transpose(1, 2).contiguous()
    side = torch.cuda.Stream()
    refused = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        side.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(side), sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
                torch.autograd.grad(out, (qt, kt, vt), dsd,
                                    retain_graph=True)
            torch.cuda.synchronize()
            break
        except RuntimeError as e:
            refused[backend.name] = str(e).strip().splitlines()[0][:300]
    else:
        return None, None, None, refused
    name = f"{backend.name} ({out.grad_fn.name()})"

    def bwd():
        torch.autograd.grad(out, (qt, kt, vt), dsd, retain_graph=True)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                bwd()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / (3 * iters), name, \
            "CUDA-graph replay", refused
    except RuntimeError as e:
        torch.cuda.synchronize()
        why = str(e).strip().splitlines()[0][:200]
    with torch.cuda.stream(side):
        bwd()
        start.record()
        for _ in range(iters):
            bwd()
        end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / iters, name,
            f"eager back-to-back calls (graph capture refused: {why})",
            refused)


def _attn_bwd_case(case, b, s, nh, nkv, hd, dev, timing=True, iters=20,
                   yardsticks=True):
    """K10 and K11 against the twin's gradients (autograd through
    ``prefill_attention_plain``) on the same inputs, each gradient tensor
    held relative to its max |twin|; a second call bit-equal to the first;
    K4's ``out`` bit-equal with and without its log-sum-exp output. With
    ``timing``: each kernel's time, bound (operations: K10 four causal
    matmuls, K11 three) and the schedule's longest CTA over the mean; with
    ``yardsticks`` also the twin's whole backward, the port's whole
    backward (``bwd_inputs``' D op, K10 and K11, as ``PrefillAttentionFn``
    runs it) and SDPA's backward (``_sdpa_bwd``) at the same shape.
    Returns the two kernels' rows."""
    import torch

    from autoawq_tpu_torch.ops import attention as at

    q = torch.randn(b, s, nh, hd, device=dev).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=dev).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=dev).to(torch.bfloat16)
    dout = torch.randn(b, s, nh * hd, device=dev).to(torch.bfloat16)
    scale = hd ** -0.5
    out, lse = at.prefill_attention_lse(q, k, v, scale)
    same = torch.equal(out, at.prefill_attention(q, k, v, scale))
    check(same, f"prefill_attention {case}: out changes with the LSE output")
    ops = at.bwd_inputs(q, k, v, out, lse, dout)
    dk, dv = at.launch_dkv(ops, scale)
    dq = at.launch_dq(ops, scale)
    again = at.launch_dkv(ops, scale) + (at.launch_dq(ops, scale),)
    repeat = all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again))
    check(repeat, f"prefill_attention_bwd {case}: a second call differs")
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = at.prefill_attention_plain(*leaves, scale)
    twin = torch.autograd.grad(ref, leaves, dout, retain_graph=timing)
    torch.cuda.synchronize()
    rows = {}
    for name, grads in (("prefill_attention_dkv", ((dk, twin[1]),
                                                   (dv, twin[2]))),
                        ("prefill_attention_dq", ((dq, twin[0]),))):
        errs = [rel_err(g[..., :hd], r) for g, r in grads]
        worst = max(e[1] for e in errs)
        rows[name] = {"phase": "kernel", "kernel": name, "case": case,
                      "B": b, "S": s, "nh": nh, "nkv": nkv, "hd": hd,
                      "max_abs_err": max(e[0] for e in errs),
                      "max_rel_err": worst, "out_bits_equal": same,
                      "repeat_bits_equal": repeat,
                      "tol": TOL["prefill_attention_bwd"]}
        check(worst <= TOL["prefill_attention_bwd"],
              f"{name} {case}: rel err {worst:.3g} > "
              f"{TOL['prefill_attention_bwd']}")
    if timing:
        pairs = b * nh * s * (s + 1) / 2  # causal (query, key) pairs
        tensor = 2 * b * s * hd  # bytes of one [B, S, heads=1, hd] bf16
        rows_in = tensor * (2 * nh + 2 * nkv) + 8 * b * nh * s  # q dO k v
        sched = getattr(at, "bwd_schedule", None)  # older --root checkouts
        work = (sched(s, ops[-1]) if sched else None)
        for name, fn, n_mm, written, w in (
                ("prefill_attention_dkv", at.launch_dkv, 4, 2 * nkv,
                 work and work[1]),
                ("prefill_attention_dq", at.launch_dq, 3, nh,
                 work and work[3])):
            r = rows[name]
            r["card"] = card()
            r["ms"], r["eager_ms"] = time_ms(fn, [[ops, scale]], iters)
            r["bound_ms"], r["bound_by"] = bound(
                rows_in + tensor * written, n_mm * 2 * hd * pairs)
            if w:
                r["cta_work_max_over_mean"] = max(w) / (sum(w) / len(w))
    if timing and yardsticks:
        whole, _ = time_ms(lambda: at.prefill_attention_bwd(
            q, k, v, out, lse, dout, scale), [[]], iters)
        library, backend, how, refused = _sdpa_bwd(q, k, v, dout, iters)
        plain, _ = time_ms(lambda: torch.autograd.grad(
            ref, leaves, dout, retain_graph=True), [[]], min(iters, 5),
            graph=False)
        for r in rows.values():
            r["plain_ms"], r["library_ms"] = plain, library
            r["port_backward_ms"] = whole
            r["plain"] = "the twin's whole backward (dq, dk and dv)"
            r["port_backward"] = ("bwd_inputs (D = rowsum(dO * O)), K10 "
                                  "and K11: dq, dk and dv")
            r["library"] = ("torch scaled_dot_product_attention's backward "
                            f"(causal, GQA; dq, dk and dv), backend "
                            f"{backend}, timed as {how}")
            r["library_refused"] = refused
    for r in rows.values():
        emit(r)
    return rows


def _head_dim_320_check(dev):
    """Past K4's and K7's widest head (256): a llama with hidden 1280,
    heads 4/2 and hd 320 (seed 0, one layer) prefills a 2 x 128 prompt
    through ``_attend`` and takes one paged step through the gather on the
    default "bespoke" route; neither launches K4 or K7, and both steps'
    logits hold the teacher-forced rule against the plain twins (bf16 and
    f32) on the card."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve.paged import paged_decode_step
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(model_type="llama", vocab_size=256, hidden_size=1280,
                      intermediate_size=512, num_hidden_layers=1,
                      num_attention_heads=4, num_key_value_heads=2,
                      head_dim=320)
    params = synth_zoo_params(cfg, 0, dev)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 128))).to(dev)
    ps, n = 64, 3  # three 64-row pages a slot: the prompt and the step
    table = torch.arange(1, 1 + 2 * n, dtype=torch.int32,
                         device=dev).reshape(2, n)
    pos = torch.full((2,), 128, dtype=torch.int32, device=dev)
    runs = {"kernel": ("auto", torch.bfloat16),
            "plain": ("plain", torch.bfloat16),
            "f32": ("plain", torch.float32)}
    first, step, token, launches = {}, {}, None, None
    for name, (method, dt) in runs.items():  # the kernel path first
        caches = gen.init_kv_cache(cfg, 2, n * ps, dt, dev)
        _build.reset_launches()
        first[name], _ = gen.prefill(cfg, params, prompt, caches, method, dt)
        if token is None:
            token = first[name].argmax(-1)[:, None]
        pool = {}
        for kv in ("k", "v"):  # the contiguous rows as pages 1.., page 0
            c = caches[0][kv]  # the trash page
            pages = c.new_zeros((c.shape[1], 1 + 2 * n, ps, c.shape[3]))
            pages[:, 1:] = c.reshape(2, c.shape[1], n, ps, c.shape[3]
                                     ).transpose(0, 1).reshape(
                c.shape[1], 2 * n, ps, c.shape[3])
            pool[kv + "_pages"] = pages
        step[name], _ = paged_decode_step(cfg, params, token, [pool], table,
                                          pos, method, dt)
        torch.cuda.synchronize()
        if launches is None:
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(not launches.get("prefill_attention")
          and not launches.get("paged_attn"),
          f"head dim 320: K4 or K7 launched ({launches})")
    rows = [{"position": p, "kernel_vs_f32": rel_err(got["kernel"],
                                                     got["f32"])[1],
             "plain_bf16_vs_f32": rel_err(got["plain"], got["f32"])[1]}
            for p, got in ((127, first), (128, step))]
    _check_teacher_forced("head dim 320 (prompt, paged step)", rows)
    emit({"phase": "kernels", "step": "head dim 320", "card": card(),
          "launches": launches, "rows": rows})


def _k5_case(rng, case, model, b, t, vl, dev, int8=False, window=None,
             bias=False, timing=True):
    """K5 against its twin at one shape (y per batch row, k_new / v_new per
    head row); with ``timing``, the times of K5 (graph replay and eager),
    the twin, SDPA over the attention phase alone, and the byte bound."""
    import torch
    import torch.nn.functional as F

    from autoawq_tpu_torch.nn.modules import _kv_quantize
    from autoawq_tpu_torch.ops import fused_attn_step as fas

    h, nh, nkv, hd = (model["hidden_size"], model["num_attention_heads"],
                      model["num_key_value_heads"], model["head_dim"])
    qkv = make_lin(rng, h, (nh + 2 * nkv) * hd, 128, True, dev)
    o = make_lin(rng, nh * hd, h, 128, True, dev)
    qkv["bias"] = ((torch.randn((nh + 2 * nkv) * hd, device=dev) * 0.5).to(
        torch.bfloat16) if bias else None)
    x = (torch.randn(b, h, device=dev) * 0.5).to(torch.bfloat16)
    kc, vc = (torch.randn(b, nkv, t, hd, device=dev) * 0.5 for _ in range(2))
    ks = vs = None
    if int8:
        (kc, ks), (vc, vs) = _kv_quantize(kc), _kv_quantize(vc)
    else:
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    theta = model.get("rope_theta", 1e4)
    ang = vl * theta ** (-torch.arange(hd // 2, device=dev) * 2.0 / hd)
    kw = dict(nh=nh, nkv=nkv, hd=hd, scale=hd ** -0.5, window=window)

    def call(fn):
        def run(x, qw, sc, qz, bias_, ow, osc, oz, kc, vc, ks, vs, cos, sin):
            return fn(x, {"qweight": qw, "scales": sc, "qzeros": qz,
                          "bias": bias_},
                      {"qweight": ow, "scales": osc, "qzeros": oz}, kc, vc,
                      cos, sin, vl, k_scales=ks, v_scales=vs, **kw)
        return run

    run, plain = call(fas.fused_attention_step), call(
        fas.fused_attention_step_plain)
    args = [x, qkv["qweight"], qkv["scales"], qkv["qzeros"], qkv["bias"],
            o["qweight"], o["scales"], o["qzeros"], kc, vc, ks, vs,
            torch.cos(ang)[None], torch.sin(ang)[None]]
    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    y_rel = row_rel_err(got[0], ref[0], h)
    kv_rel = max(row_rel_err(got[1], ref[1], hd),
                 row_rel_err(got[2], ref[2], hd))
    row = {"phase": "kernel", "kernel": "fused_attn_step", "case": case,
           "card": card(), "B": b, "H": h, "nh": nh, "nkv": nkv, "hd": hd, "T": t, "vl": vl,
           "window": window, "cache": "int8" if int8 else "bf16",
           "qkv_bias": bias, "max_abs_err": rel_err(got[0], ref[0])[0],
           "max_row_rel_err": y_rel, "kv_max_row_rel_err": kv_rel,
           "tol": TOL["fused_attn_step"],
           "kv_tol": TOL["fused_attn_step_kv"]}
    check(y_rel <= TOL["fused_attn_step"]
          and kv_rel <= TOL["fused_attn_step_kv"]
          and bool(torch.isfinite(got[0]).all()),
          f"fused_attn_step {case}: y per-row rel err {y_rel:.3g}, "
          f"k/v {kv_rel:.3g}")
    if timing:
        lo = 0 if window is None else max(0, vl - window + 1)
        rows = vl - lo  # the cache rows this call must read
        elem = 1 if int8 else 2
        wb = lin_bytes(qkv) + lin_bytes(o)
        cache_b = 2 * b * nkv * rows * (hd * elem + (4 if int8 else 0))
        io_b = 2 * b * h * 2 + 2 * b * nkv * hd * (4 if int8 else 2)
        sets = copies(args, wb + 2 * kc.numel() * elem)
        row["ms"], row["eager_ms"] = time_ms(run, sets, 100)
        row["plain_ms"], _ = time_ms(plain, sets[:2], 5)
        row["library_ms"] = None
        row["library"] = "none computes the whole step in one call"
        flops = (2 * b * (h * (nh + 2 * nkv) * hd + nh * hd * h)
                 + 4 * b * nh * (rows + 1) * hd)
        row["bound_ms"], row["bound_by"] = bound(wb + cache_b + io_b, flops)
        if rows:
            qa = torch.randn(b, nh, 1, hd, device=dev).to(torch.bfloat16)
            ka, va = ((c[:, :, lo:vl].float() * (s_[:, :, lo:vl, None]
                                                 if int8 else 1.0)
                       ).to(torch.bfloat16).contiguous()
                      for c, s_ in ((kc, ks), (vc, vs)))

            def sdpa(a, b_, c):
                return F.scaled_dot_product_attention(a, b_, c,
                                                      enable_gqa=True)
            row["sdpa_attention_phase_ms"], _ = time_ms(sdpa, [[qa, ka, va]],
                                                        100)
            row["sdpa_note"] = ("torch scaled_dot_product_attention with "
                                "enable_gqa over the attention phase alone, "
                                "on a bf16 copy of the valid rows: not the "
                                "whole function")
    emit(row)
    return row


def _moe_case(gen, case, w, t, dev, timing=True, iters=50,
              yardsticks=True, time_plain=True, k=2):
    """K6 against its twin: ``t`` tokens routed to ``k`` of the stack's
    experts each (distinct, as top-k picks them), the tables from
    ``moe_align``.
    With ``timing``: K6 (graph replay and eager), the twin (eager: it reads
    the table on the host), bf16 ``torch.matmul`` per owned expert over its
    pre-dequantized weight, summed, and the bound for the experts and rows
    this routing needs (the twin and the matmuls only with
    ``yardsticks``, the twin not without ``time_plain``)."""
    import torch

    from autoawq_tpu_torch.ops import gemm
    from autoawq_tpu_torch.ops import moe_gemm as mg

    e, k8, n = w["qweight"].shape
    kdim = 8 * k8
    topi = torch.rand(t, e, device=dev, generator=gen).topk(k, -1).indices
    bm = mg.pick_block_m(t * k, e)
    gather_idx, be, live, _ = mg.moe_align(topi, e, bm)
    x = (torch.randn(t, kdim, device=dev, generator=gen) * 0.5).to(
        torch.bfloat16)
    xs = torch.cat([x, x.new_zeros((1, kdim))])[
        torch.clamp(gather_idx.long() // k, max=t)]
    args = [xs, be, w["qweight"], w["scales"], w["qzeros"], live]

    def run(xs, be, qw, sc, qz, live):
        return mg.grouped_awq_matmul(xs, be, qw, sc, qz, block_m=bm,
                                     live_blocks=live, max_live=t * k)

    def plain(xs, be, qw, sc, qz, live):
        return mg.grouped_awq_matmul_plain(xs, be, qw, sc, qz, block_m=bm,
                                           live_blocks=live)

    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    nlive = int(live)
    dead_zero = not bool(got[nlive * bm:].any())
    owned = sorted(set(topi.flatten().tolist()))
    row = {"phase": "kernel", "kernel": "moe_gemm", "case": case,
           "card": card(), "experts": e, "top_k": k, "entries": t * k,
           "block_m": bm,
           "blocks": be.numel(), "live_blocks": nlive,
           "owned_experts": len(owned), "K": kdim, "N": n,
           "gs": kdim // w["scales"].shape[1],
           "zp": w["qzeros"] is not None, "max_abs_err": err,
           "max_rel_err": rel, "dead_rows_zero": dead_zero,
           "tol": TOL["moe_gemm"]}
    check(rel <= TOL["moe_gemm"] and dead_zero,
          f"moe_gemm {case}: rel err {rel:.3g}, dead rows zero {dead_zero}")
    if timing:
        read = len(owned) * sum(t_.numel() * t_.element_size() // e
                                for t_ in w.values() if t_ is not None)
        sets = copies(args, read)
        row["ms"], row["eager_ms"] = time_ms(run, sets, iters)
        row["bound_ms"], row["bound_by"] = bound(
            read + 2 * t * k * (kdim + n), 2 * t * k * kdim * n)
    if timing and yardsticks:
        if time_plain:
            row["plain_ms"], _ = time_ms(plain, sets[:1], 3, graph=False)
        flat = []
        for ex in owned:
            flat += [x[(topi == ex).any(-1)], gemm.dequantize(
                w["qweight"][ex], w["scales"][ex],
                None if w["qzeros"] is None else w["qzeros"][ex],
                dtype=torch.bfloat16)]

        def per_expert_matmuls(*a):
            return [torch.matmul(a[i], a[i + 1]) for i in range(0, len(a), 2)]
        row["matmul_per_expert_ms"], _ = time_ms(
            per_expert_matmuls,
            copies(flat, sum(f.numel() * 2 for f in flat[1::2])), iters)
        row["library_ms"] = None
        row["library"] = ("none: no one call computes a grouped int4 GEMM; "
                          "matmul_per_expert_ms is bf16 torch.matmul per "
                          "owned expert over its pre-dequantized weight, "
                          "summed")
    emit(row)
    return row


def _moe_mlp_case(gen, gu, dn, t, dev):
    """``moe_mlp`` (two K6 calls) against its plain twin, end to end."""
    import torch

    from autoawq_tpu_torch.ops import moe_gemm as mg

    e, k8, n2 = gu["qweight"].shape
    x = (torch.randn(t, 8 * k8, device=dev, generator=gen) * 0.5).to(
        torch.bfloat16)
    topi = torch.rand(t, e, device=dev, generator=gen).topk(2, -1).indices
    topw = torch.softmax(torch.rand(t, 2, device=dev, generator=gen), -1)
    stacked = {"gate_up_proj": gu, "down_proj": dn}
    got = mg.moe_mlp(stacked, x, topw, topi, "silu", n2 // 2)
    ref = mg.moe_mlp(stacked, x, topw, topi, "silu", n2 // 2, method="plain")
    err, rel = rel_err(got, ref)
    check(rel <= TOL["moe_mlp"], f"moe_mlp T={t}: rel err {rel:.3g}")
    emit({"phase": "kernel", "kernel": "moe_gemm", "case": f"moe_mlp T={t}",
          "experts": e, "entries": 2 * t, "max_abs_err": err,
          "max_rel_err": rel, "tol": TOL["moe_mlp"]})


def _mlp3_case(rng, case, m, h, inter, act, dev, timing=True,
               zp=(True, True, True), gs=128):
    """K8 against its twin at group size ``gs``; with ``timing``, the times
    of K8, the twin, the unfused chain on K1 (``_unfused_chain``: gate, up,
    act * up, down) and K3 on the same weights fused into one gate_up (no
    PyTorch call computes the function), and the byte bound."""
    import torch

    from autoawq_tpu_torch.ops import fused_mlp as fm
    from autoawq_tpu_torch.ops import sharded_mlp as sm

    g = make_lin(rng, h, inter, gs, zp[0], dev)
    u = make_lin(rng, h, inter, gs, zp[1], dev)
    d = make_lin(rng, inter, h, gs, zp[2], dev)
    x = (torch.randn(m, h, device=dev) * 0.5).to(torch.bfloat16)
    args = [x] + [lin[key] for lin in (g, u, d)
                  for key in ("qweight", "scales")] + [
        g["qzeros"], u["qzeros"], d["qzeros"]]

    def run(*a):
        return sm.fused_mlp3(*a, inter=inter, act=act)

    def plain(*a):
        return sm.fused_mlp3_plain(*a, inter=inter, act=act)

    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    row = {"phase": "kernel", "kernel": "fused_mlp3", "case": case,
           "card": card(), "M": m, "H": h, "inter": inter, "act": act,
           "group_size": gs, "zp": list(zp), "max_abs_err": err,
           "max_rel_err": rel,
           "tol": TOL["fused_mlp3"]}
    check(rel <= TOL["fused_mlp3"], f"fused_mlp3 {case}: rel err {rel:.3g}")
    if timing:
        wb = lin_bytes(g) + lin_bytes(u) + lin_bytes(d)
        sets = copies(args, wb)
        row["ms"], row["eager_ms"] = time_ms(run, sets, 200)
        row["plain_ms"], _ = time_ms(plain, sets[:2], 10)
        chain, chain_args = _unfused_chain(inter, act, (g, u, d))
        row["unfused_chain_ms"], _ = time_ms(
            chain, copies([x] + chain_args, wb), 200)
        if all(zp):
            gu = {key: torch.cat([g[key], u[key]], dim=1)
                  for key in ("qweight", "scales", "qzeros")}
            k3 = [x, gu["qweight"], gu["scales"], d["qweight"], d["scales"],
                  gu["qzeros"], d["qzeros"]]
            row["k3_fused_ms"], _ = time_ms(
                lambda *a: fm.fused_mlp(*a, inter=inter, act=act),
                copies(k3, wb), 200)
        row["library_ms"] = None
        row["library"] = ("none: no PyTorch call computes the function; "
                          "k3_fused_ms is K3 on the same weights fused")
        row["bound_ms"], row["bound_by"] = bound(
            wb + 2 * m * h * 2, 2 * m * 3 * h * inter)
    emit(row)
    return row


def _paged_case(gen, kernel, case, model, dev, int8=False, window=None,
                softcap=None, alibi=False, timing=True, ppcb=8,
                lengths=PAGED_LENGTHS, pps=PAGED_POOL["pages_per_seq"],
                yardsticks=True):
    """K7 (``kernel="paged_attn"``) or K9 (``"paged_attn_stock"``) against
    its twin on a pool of H's size (136 pages of 64 rows, 8 pages a slot,
    ``PAGED_LENGTHS``), or on ``pps`` pages a slot for ``lengths`` (a pool
    of one page more than the slots own), per (slot, head) row. With
    ``timing``: graph-replay and eager times, the twin's time, the
    yardstick (the table's pages gathered with index_select plus one SDPA
    with a length mask, timed together) and the byte bound over the live
    rows (without ``yardsticks``, the kernel's times and bound only)."""
    import torch
    import torch.nn.functional as F

    from autoawq_tpu_torch.nn.modules import _kv_quantize
    from autoawq_tpu_torch.ops import paged_attn as pa

    nh, nkv, hd = (model["num_attention_heads"],
                   model["num_key_value_heads"], model["head_dim"])
    b, ps = len(lengths), PAGED_POOL["page_size"]
    n_pool = max(PAGED_POOL["total_pages"], b * pps + 1)
    q = torch.randn(b, nh, hd, device=dev, generator=gen)
    kp, vp = (torch.randn(nkv, n_pool, ps, hd, device=dev, generator=gen)
              * 0.5 for _ in range(2))
    table = (torch.randperm(n_pool - 1, device=dev, generator=gen)[
        : b * pps] + 1).reshape(b, pps).to(torch.int32)
    lens = lengths
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    table[lengths == 1] = 0  # inactive slots hold the trash page
    scale = hd ** -0.5
    ks = vs = None
    if int8:
        (kp, ks), (vp, vs) = _kv_quantize(kp), _kv_quantize(vp)
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    if kernel == "paged_attn":
        slopes = (torch.rand(nh, device=dev, generator=gen) * 0.1
                  if alibi else None)
        args = [q, kp, vp, table, lengths, ks, vs, slopes]

        def run(q, kp, vp, table, lengths, ks, vs, slopes):
            return pa.paged_decode_attention(
                q, kp, vp, table, lengths, scale=scale, k_scales=ks,
                v_scales=vs, softcap=softcap, window=window,
                alibi_slopes=slopes)

        def plain(q, kp, vp, table, lengths, ks, vs, slopes):
            return pa.paged_decode_attention_plain(
                q, kp, vp, table, lengths, scale=scale, k_scales=ks,
                v_scales=vs, softcap=softcap, window=window,
                alibi_slopes=slopes)
    else:
        args = [(q * scale).to(torch.bfloat16), kp, vp, lengths, table]

        def run(q, kp, vp, lengths, table):
            return pa.stock_paged_attention(
                q, kp, vp, lengths, table, pages_per_compute_block=ppcb,
                softcap=softcap)

        def plain(q, kp, vp, lengths, table):
            return pa.stock_paged_attention_plain(
                q, kp, vp, lengths, table, pages_per_compute_block=ppcb,
                softcap=softcap)
    got, ref = run(*args), plain(*args)
    torch.cuda.synchronize()
    rel = row_rel_err(got, ref, hd)
    vl = lengths.long()
    lo = (vl - window).clamp_min(0) if window else torch.zeros_like(vl)
    live = int((vl.clamp(max=pps * ps) - lo).sum())  # rows the call needs
    row = {"phase": "kernel", "kernel": kernel, "case": case, "card": card(),
           "B": b, "nh": nh, "nkv": nkv, "hd": hd, "ps": ps, "PPS": pps,
           "pool": "int8" if int8 else "bf16",
           "lengths": lens if len(set(lens)) > 1 else f"{b} x {lens[0]}",
           "live_rows": live, "window": window, "softcap": softcap,
           "ppcb": ppcb if kernel == "paged_attn_stock" else None,
           "alibi": alibi, "max_abs_err": rel_err(got, ref)[0],
           "max_row_rel_err": rel, "tol": TOL[kernel]}
    check(rel <= TOL[kernel] and bool(torch.isfinite(got).all()),
          f"{kernel} {case}: per-row rel err {rel:.3g}")
    if kernel == "paged_attn_stock":  # K9's bf16 outputs apart, in ulps
        ulps = (bf16_order(got) - bf16_order(ref)).abs()
        row["ulps_max"] = int(ulps.max())
        row["share_one_ulp"] = float((ulps == 1).float().mean())
        row["share_over_one_ulp"] = float((ulps > 1).float().mean())
    if timing:
        elem = 1 if int8 else 2
        io = 4 if kernel == "paged_attn" else 2  # q and out: f32 or bf16
        nbytes = (2 * live * nkv * hd * elem + (8 * live * nkv if int8 else 0)
                  + 2 * b * nh * hd * io + 4 * b * (pps + 1))
        sets = copies(args, 2 * live * nkv * hd * elem)
        row["ms"], row["eager_ms"] = time_ms(run, sets, 200)
        row["bound_ms"], row["bound_by"] = bound(nbytes,
                                                 4 * nh * hd * live)
        if not yardsticks:
            emit(row)
            return row
        row["plain_ms"], _ = time_ms(plain, sets[:2], 10)
        row["library_ms"] = None
        row["library"] = "none for an int8 pool"
        if not int8:
            flat = table.reshape(-1).long()
            t = pps * ps
            mask = (torch.arange(t, device=dev)[None, :]
                    < vl[:, None])[:, None, None, :]
            qb = q.to(torch.bfloat16)[:, :, None, :]

            def library(qb, kp, vp, flat, mask):
                kb = kp.index_select(1, flat).view(nkv, b, t, hd)
                vb = vp.index_select(1, flat).view(nkv, b, t, hd)
                return F.scaled_dot_product_attention(
                    qb, kb.transpose(0, 1), vb.transpose(0, 1),
                    attn_mask=mask, scale=scale, enable_gqa=True)
            row["library_ms"], _ = time_ms(library, copies(
                [qb, kp, vp, flat, mask], 2 * live * nkv * hd * elem), 200)
            row["library"] = ("the table's pages gathered with index_select "
                              "plus torch scaled_dot_product_attention "
                              "(enable_gqa, length mask), timed together")
    emit(row)
    return row


def phase_kernels(dev):
    """Every kernel against its twin at the main path's shapes. Returns the
    representative row per kernel for the ``kernels`` line."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.utils.synth import synth_qlin

    rng = np.random.default_rng(1)
    torch.manual_seed(1)  # the activations and caches drawn on the card
    rep = {}
    for m in (1, 8):
        for case, (k, n) in LINEARS.items():
            row = _gemm_case(rng, "w4a16_gemv", case, m, k, n, 128, True, dev)
            if m == 1 and case == "qkv":
                rep["w4a16_gemv"] = row
    for m in (1, 8, 64):  # Mistral's qkv and o: E, H, I, J, K decode and
        for case in ("qkv", "o"):  # H's and K's M=64 prefills
            k, n = D_LINEARS[case]
            _gemm_case(rng, "w4a16_gemv", f"Mistral {case}", m, k, n, 128,
                       True, dev)
    for gs, zp in ((32, True), (64, True), (128, False)):
        _gemm_case(rng, "w4a16_gemv", "qkv", 1, 2048, 2560, gs, zp, dev)
    for case, (k, n) in LINEARS.items():  # K1 at the K1/K2 switch point
        _gemm_case(rng, "w4a16_gemv", case, 256, k, n, 128, True, dev)
    for m in (256, 768):
        for case, (k, n) in LINEARS.items():
            row = _gemm_case(rng, "w4a16_gemm", case, m, k, n, 128, True, dev)
            if m == 768 and case == "gate_up":
                rep["w4a16_gemm"] = row
    for case, (k, n) in D_LINEARS.items():  # K2 at traffic D's prefill
        _gemm_case(rng, "w4a16_gemm", f"D {case}", D_M, k, n, 128, True, dev,
                   iters=10)
    _gemm_case(rng, "w4a16_gemm", "ragged", 300, 2048, 2500, 32, False, dev,
               timing=False)
    _gemm_case(rng, "w4a16_gemm", "K % 64 = 32, g32", 512, 2080, 1024, 32,
               True, dev, timing=False)
    for m in (1, 8):
        row = _mlp_case(rng, m, "silu", dev)
        if m == 1:
            rep["fused_mlp"] = row
    for m in (1, 8):  # H's and K's decode MLP (Mistral, 8 slots busy)
        _mlp_case(rng, m, "silu", dev, h=MISTRAL["hidden_size"],
                  inter=MISTRAL["intermediate_size"], case="Mistral")
    _mlp_case(rng, 3, "gelu_pytorch_tanh", dev, timing=False)
    _mlp_case(rng, 20, "gelu", dev, timing=False)
    rep["prefill_attention"] = _attn_case(2, 384, 32, 4, 64, dev)
    _attn_case(*D_ATTN, dev, iters=10, case="D prefill")
    for hd in (128, 96, 256):  # 96 is zero-padded to K4's 128 instance
        _attn_case(1, 200, 8, 2, hd, dev, timing=False)
    _head_dim_320_check(dev)
    # K10 and K11 at traffic W's step (Mistral's heads), then TinyLlama's,
    # GPT-J's hd 256, a length off the 64-row tiles, B = 1 and a padded hd
    rep.update(_attn_bwd_case("W: Mistral", *TRAIN_ATTN, dev))
    for case, shape in (("TinyLlama", (2, 384, 32, 4, 64)),
                        ("GPT-J hd 256", (2, 384, 16, 16, 256))):
        _attn_bwd_case(case, *shape, dev)  # timed, SDPA's backward beside
    for case, shape in (("S = 300", (2, 300, 32, 8, 128)),
                        ("B = 1", (1, 512, 32, 8, 128)),
                        ("hd 96, padded", (1, 200, 8, 2, 96)),
                        ("S = 1000, rep 8", (1, 1000, 32, 4, 128)),
                        ("hd 256, GQA", (2, 384, 16, 4, 256))):
        _attn_bwd_case(case, *shape, dev, timing=False)
    # K5 at traffic C's and D's last decode step, then the edge shapes
    rep["fused_attn_step"] = _k5_case(rng, "C: Mistral bf16", MISTRAL, 8,
                                      128, 127, dev)
    _k5_case(rng, "D: Mistral int8", MISTRAL, 8, 2112, 2111, dev, int8=True)
    _k5_case(rng, "TinyLlama bf16, rep 8, hd 64", TINYLLAMA, 8, 128, 127,
             dev, timing=False)
    _k5_case(rng, "vl = 0", MISTRAL, 1, 128, 0, dev, timing=False)
    _k5_case(rng, "window 1024", MISTRAL, 8, 2112, 2000, dev, window=1024,
             timing=False)
    _k5_case(rng, "qkv bias", MISTRAL, 8, 128, 100, dev, bias=True,
             timing=False)
    # K8 at traffic G's shapes and a Mixtral expert's, then the edge cases
    for m in (1, 8):
        row = _mlp3_case(rng, f"TinyLlama M={m}", m, 2048, 5632, "silu", dev)
        if m == 1:
            rep["fused_mlp3"] = row
    _mlp3_case(rng, "Mixtral expert M=1", 1, 4096, 14336, "silu", dev)
    _mlp3_case(rng, "gelu tanh, symmetric", 3, 2048, 5632,
               "gelu_pytorch_tanh", dev, timing=False, zp=(False,) * 3)
    _mlp3_case(rng, "exact gelu, mixed zeros", 20, 2048, 5632, "gelu", dev,
               timing=False, zp=(True, False, True))
    # K6 at traffic E's and F's shapes over 8 Mixtral experts
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    h, inter, ne = (MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"],
                    MIXTRAL["num_experts"])
    gu = synth_qlin(gen, h, 2 * inter, experts=ne)
    dn = synth_qlin(gen, inter, h, experts=ne)
    rep["moe_gemm"] = _moe_case(gen, "E decode, gate_up", gu, 1, dev)
    _moe_case(gen, "E decode, down", dn, 1, dev)
    _moe_case(gen, "E prefill, gate_up (bm 8)", gu, 64, dev)
    _moe_case(gen, "F decode, gate_up", gu, 8, dev)
    _moe_case(gen, "F decode, down", dn, 8, dev)
    _moe_case(gen, "F prefill, gate_up (bm 128)", gu, 4096, dev, iters=10)
    _moe_case(gen, "F prefill, down (bm 128)", dn, 4096, dev, iters=10)
    for t in (1, 8):
        _moe_mlp_case(gen, gu, dn, t, dev)
    del gu, dn
    _moe_case(gen, "symmetric", synth_qlin(gen, h, 2 * inter, zp=False,
                                           experts=ne), 1, dev,
              timing=False)
    _moe_case(gen, "g64", synth_qlin(gen, h, 2 * inter, gs=64,
                                     experts=ne), 8, dev, timing=False)
    small = synth_qlin(gen, 1024, 640, experts=ne)
    _moe_case(gen, "dead blocks", small, 3, dev, timing=False)
    _moe_case(gen, "bm 32", small, 512, dev, timing=False)
    _moe_case(gen, "bm 96, masked 128-row tile", small, 1536, dev,
              timing=False)
    del small
    # K7 and K9 at H's decode shape (I's int8 pool for K7), then the edges
    rep["paged_attn"] = _paged_case(gen, "paged_attn", "H: Mistral bf16",
                                    MISTRAL, dev)
    _paged_case(gen, "paged_attn", "I: Mistral int8", MISTRAL, dev,
                int8=True)
    for case, kw in (("window 100", dict(window=100)),
                     ("softcap 30", dict(softcap=30.0)),
                     ("ALiBi slopes", dict(alibi=True)),
                     ("int8, window, softcap, ALiBi",
                      dict(int8=True, window=100, softcap=30.0,
                           alibi=True))):
        _paged_case(gen, "paged_attn", case, MISTRAL, dev, timing=False,
                    **kw)
    _paged_case(gen, "paged_attn", "TinyLlama widths, rep 8", TINYLLAMA, dev,
                timing=False)
    rep["paged_attn_stock"] = _paged_case(gen, "paged_attn_stock",
                                          "J: Mistral bf16", MISTRAL, dev)
    _paged_case(gen, "paged_attn_stock", "softcap 30, 2 pages a block",
                MISTRAL, dev, softcap=30.0, ppcb=2, timing=False)
    _paged_case(gen, "paged_attn_stock", "TinyLlama widths, rep 8 (bf16 "
                "running output)", TINYLLAMA, dev, timing=False)
    _paged_split_cases(gen, dev)
    for kernel in ("paged_attn", "paged_attn_stock"):
        _paged_case(gen, kernel, "long table: 8 x 4096 rows", MISTRAL, dev,
                    **LONG_TABLE)
    return rep, _omni_kernel_rows(rng, dev)


def _omni_kernel_rows(rng, dev):
    """K1 at Qwen2.5-Omni's thinker decode (fused qkv with its bias's
    shape, o; M = 1), K3 at its MLP (M = 1) and K4 at the talker's prompt
    (B = 1, S = traffic AU's rows, 12 / 4 heads x 128), each against its
    twin and timed with its bound and library call."""
    from autoawq_tpu_torch.models.config import ModelConfig

    c = ModelConfig.from_hf_dict(QWEN25_OMNI_7B)
    t = QWEN25_OMNI_7B["talker_config"]
    hd, nh, nkv, h = (c.head_dim_, c.num_attention_heads,
                      c.num_key_value_heads, c.hidden_size)
    s = sum(OMNI_TEXT) + OMNI_MEL // 4
    return [_gemm_case(rng, "w4a16_gemv", "Qwen2.5-Omni thinker qkv", 1, h,
                       (nh + 2 * nkv) * hd, 128, True, dev),
            _gemm_case(rng, "w4a16_gemv", "Qwen2.5-Omni thinker o", 1,
                       nh * hd, h, 128, True, dev),
            _mlp_case(rng, 1, "silu", dev, h=h, inter=c.intermediate_size,
                      case="Qwen2.5-Omni thinker"),
            _attn_case(1, s, t["num_attention_heads"],
                       t["num_key_value_heads"], t["head_dim"], dev,
                       case="Qwen2.5-Omni talker prompt")]


def _paged_split_cases(gen, dev):
    """K7 and K9 at the edges of their splits (one 64-row page a split),
    against their twins at the usual limits."""
    edges = dict(lengths=[63, 64, 65, 4095, 4096], pps=64)
    ones = dict(lengths=[1] * 8)
    for case, kw in (("lengths at split edges", edges),
                     ("every slot of length 1", ones),
                     ("window 70 cuts a split", dict(window=70)),
                     ("int8, softcap, ALiBi across splits",
                      dict(int8=True, softcap=30.0, alibi=True, **edges))):
        _paged_case(gen, "paged_attn", case, MISTRAL, dev, timing=False,
                    **kw)
    for case, kw in (("lengths at split edges", edges),
                     ("every slot of length 1", ones),
                     ("rep 8, 2 pages a block, 16-page table",
                      dict(ppcb=2, pps=16, lengths=[1, 1024, 77, 128, 300,
                                                    1, 64, 999]))):
        _paged_case(gen, "paged_attn_stock", case,
                    TINYLLAMA if "rep 8" in case else MISTRAL, dev,
                    timing=False, **kw)


def _teacher_forced(cfg, params, prompt, steps, kv_quant=False,
                    embeds=None):
    """Kernel path (bf16), plain twins (bf16) and plain twins in f32 on the
    same tokens, all three with the same cache type: prefill logits, then
    ``steps`` decode steps fed the kernel path's greedy tokens. Returns
    per-position errors against f32. ``embeds`` ({dtype: [B, S, H]}) is a
    multimodal prompt's input embeds, computed in each run's dtype."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    runs = {"kernel": ("auto", torch.bfloat16), "plain": ("plain",
                                                          torch.bfloat16),
            "plain_f32": ("plain", torch.float32)}
    caches = {k: gen.init_kv_cache(cfg, b, s + steps, dt, prompt.device,
                                   kv_quant=kv_quant)
              for k, (_, dt) in runs.items()}
    logits = {k: gen.prefill(cfg, params, prompt, caches[k], m, dt,
                             embeds=None if embeds is None
                             else embeds[dt])[0]
              for k, (m, dt) in runs.items()}
    rows = []
    for step in range(steps + 1):
        ref = logits["plain_f32"]
        _, k_rel = rel_err(logits["kernel"], ref)
        _, p_rel = rel_err(logits["plain"], ref)
        _, kp_rel = rel_err(logits["kernel"], logits["plain"])
        agree = (logits["kernel"].argmax(-1) == ref.argmax(-1)).float().mean()
        rows.append({"position": s + step - 1, "kernel_vs_f32": k_rel,
                     "plain_bf16_vs_f32": p_rel, "kernel_vs_plain": kp_rel,
                     "argmax_agree_f32": agree.item()})
        if step == steps:
            break
        token = logits["kernel"].argmax(-1)[:, None]
        logits = {k: gen.decode_step(cfg, params, token, caches[k], s + step,
                                     m, dt)[0]
                  for k, (m, dt) in runs.items()}
    return rows


def device_profile(run, calls: int, match=(), host_ops=True):
    """``utils/profiling.device_kernels`` over ``calls`` calls of
    ``run(i)``: host wall ms per call, device ms per call, the device's
    busy share, device activities (kernels, copies) per call, and device
    time by kernel name (the twelve largest, and every kernel whose name
    holds a string of ``match``). Only the device's own events are summed:
    an operator's row repeats the time of the kernels it launched.
    ``host_ops=False`` records the device alone, for a call of tens of
    thousands of host operators, whose records would take the profiler
    longer to process than the call."""
    import torch

    from autoawq_tpu_torch.utils.profiling import device_kernels

    def calls_():
        for i in range(calls):
            run(i)
    _, wall, kernels = device_kernels(calls_, torch.device("cuda"),
                                      host_ops=host_ops)
    rows = sorted(((us, n, k) for k, (n, us) in kernels.items()),
                  reverse=True)
    dev_us = sum(r[0] for r in rows)
    check(dev_us > 0, "torch.profiler recorded no device time")
    def kernel_rows(sel):
        return [{"name": k[:80], "us_per_call": us / calls,
                 "count_per_call": n / calls} for us, n, k in sel]
    out = {"calls": calls, "wall_ms_per_call": wall * 1e3 / calls,
           "device_ms_per_call": dev_us / 1e3 / calls,
           "device_busy_share": dev_us / 1e6 / wall,
           "device_activities_per_call": sum(r[1] for r in rows) / calls,
           "by_kernel": kernel_rows(rows[:12])}
    if match:
        out["matched"] = kernel_rows([r for r in rows
                                      if any(m in r[2] for m in match)])
    return out


def profile_decode(cfg, params, prompt, steps, kv_quant=False, match=()):
    """``device_profile`` over ``steps`` greedy decode steps after a
    prefill of ``prompt`` (kernel rows named with ``match`` kept)."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    caches = gen.init_kv_cache(cfg, b, s + steps + 1, torch.bfloat16,
                               prompt.device, kv_quant=kv_quant)
    logits, _ = gen.prefill(cfg, params, prompt, caches)
    token = [logits.argmax(-1)[:, None]]

    def step(i):
        logits, _ = gen.decode_step(cfg, params, token[0], caches, s + i)
        token[0] = logits.argmax(-1)[:, None]
    return device_profile(step, steps, match=match)


def phase_e2e(dev):
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**TINYLLAMA)
    t0 = time.perf_counter()
    params = synth_zoo_params(cfg, 0, dev)
    torch.cuda.synchronize()
    emit({"phase": "e2e", "step": "synth", "layers": cfg.num_hidden_layers,
          "seconds": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    prompt_a = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(
        dev)
    counts = {}

    def run_gen(prompt, n):
        t = time.perf_counter()
        out = gen.generate_compiled(cfg, params, prompt, n,
                                    dtype=torch.bfloat16)
        out = out.cpu()
        return time.perf_counter() - t, out

    # traffic A: bs1 ctx64 greedy decode (bench.py's shape)
    _build.reset_launches()
    tok_s, t_small, t_big, per_token, out_a = _quotient(
        lambda n: run_gen(prompt_a, n), 32, DECODE_BIG, 2, warm=(32,))
    counts["A"] = dict(_build.LAUNCHES)
    check(out_a.shape == (1, 64 + DECODE_BIG), "traffic A output shape")
    emit({"phase": "e2e", "traffic": "A", "batch": 1, "prompt": 64,
          "decode_tok_s": tok_s, "t_32_s": t_small,
          f"t_{DECODE_BIG}_s": t_big,
          "launches": counts["A"], "launches_per_decode_token": per_token})

    emit({"phase": "e2e", "step": "profile", "traffic": "A",
          "what": "decode_step", **profile_decode(cfg, params, prompt_a, 16)})

    # traffic B: bs2, two 384-token prompts, 32 new tokens
    prompt_b = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 384))).to(dev)
    _build.reset_launches()
    caches = gen.init_kv_cache(cfg, 2, 384 + 32, torch.bfloat16, dev)
    gen.prefill(cfg, params, prompt_b, caches)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    gen.prefill(cfg, params, prompt_b, caches)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t
    dt, out_b = run_gen(prompt_b, 32)
    counts["B"] = dict(_build.LAUNCHES)
    check(out_b.shape == (2, 384 + 32), "traffic B output shape")
    emit({"phase": "e2e", "traffic": "B", "batch": 2, "prompt": 384,
          "prefill_s": t_prefill, "prefill_tok_s": 2 * 384 / t_prefill,
          "generate_32_s": dt, "tokens_generated": int(out_b.shape[0] * 32),
          "launches": counts["B"]})
    emit({"phase": "e2e", "step": "profile", "traffic": "B",
          "what": "prefill", **device_profile(
              lambda i: gen.prefill(cfg, params, prompt_b, caches), 3)})
    peak = torch.cuda.max_memory_allocated()

    # kernel path vs plain twins on the card, teacher-forced. Tolerance:
    # the kernel path's distance from the f32 plain run must stay within
    # twice the bf16 plain run's own distance from it (+1e-3), i.e. the
    # kernels add no more error than bf16 arithmetic already does.
    for name, prompt in (("A", prompt_a), ("B", prompt_b)):
        rows = _teacher_forced(cfg, params, prompt, 8 if name == "A" else 1)
        _check_teacher_forced(name, rows)
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "rows": rows})
    emit({"phase": "e2e", "model": "tinyllama", "peak_memory_bytes": peak})
    del params
    counts["G"], per_token_g = _traffic_g(cfg, prompt_a, dev)
    counts_cd, per_step_cd = _mistral_traffics(dev)
    counts_ef, per_step_ef = _mixtral_traffics(dev)
    counts.update(counts_cd)
    counts.update(counts_ef)
    total = {k: sum(c[k] for c in counts.values()) for k in counts["A"]}
    for name, n in total.items():
        # K4's backward launches only in the train phase, which holds its
        # launches a step exactly
        if name not in BACKWARD_KERNELS:
            check(n > 0, f"kernel {name} never launched on the main path")
    return total, {"A": per_token, "G": per_token_g, **per_step_cd,
                   **per_step_ef}


def _quotient(run, small: int, big: int, reps: int, warm=()):
    """Decode steps per second by the difference quotient of a ``small``-
    and a ``big``-token generation, min of ``reps`` runs each (``run(n)``
    returns (seconds, output)), and the launches per decode step from the
    same runs: the quotient cancels prefill and fixed costs. Returns
    (steps/s, small times, big times, launches per step, last output)."""
    from autoawq_tpu_torch.ops import _build

    for n in warm:
        run(n)
    t_small, t_big = [], []
    for _ in range(reps):
        before = dict(_build.LAUNCHES)
        t_small.append(run(small)[0])
        mid = dict(_build.LAUNCHES)
        dt, out = run(big)
        t_big.append(dt)
        after = dict(_build.LAUNCHES)
    per_step = {k: ((after[k] - mid[k]) - (mid[k] - before[k])) / (big - small)
                for k in after}
    rate = (big - small) / max(min(t_big) - min(t_small), 1e-9)
    return rate, t_small, t_big, per_step, out


def _traffic_g(cfg, prompt, dev):
    """Traffic G: TinyLlama unfused (seed 0, drawn on the card, q/k/v and
    gate/up split) as the facade's default ``from_quantized`` leaves a
    checkpoint, driven
    through ``AwqCausalLM.generate``: K1 for q, k, v and o, K8 for the MLP.
    Decode tok/s by A's method (``DECODE_BIG``- and 32-token quotient, min
    of 2)."""
    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    model = AwqCausalLM(cfg, _unfused(cfg, synth_zoo_params(cfg, 0, dev)),
                        device=dev)
    assert "gate_proj" in model.params["layers"][0]["mlp"]

    def run(n):
        t = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=n).cpu()
        return time.perf_counter() - t, out

    _build.reset_launches()
    tok_s, t_small, t_big, per_token, out = _quotient(run, 32, DECODE_BIG,
                                                      2, warm=(32,))
    counts = dict(_build.LAUNCHES)
    layers = cfg.num_hidden_layers
    check(out.shape == (1, prompt.shape[1] + DECODE_BIG),
          "traffic G output shape")
    check(per_token["fused_mlp3"] == layers and per_token["fused_mlp"] == 0,
          f"traffic G: {per_token['fused_mlp3']} fused_mlp3 launches per "
          f"decode step, expected {layers}")
    emit({"phase": "e2e", "traffic": "G", "card": card(), "batch": 1,
          "prompt": prompt.shape[1], "layout": "unfused",
          "method": f"A's: {DECODE_BIG}- and 32-token quotient, min of 2",
          "decode_tok_s": tok_s, "t_32_s": t_small,
          f"t_{DECODE_BIG}_s": t_big,
          "launches": counts, "launches_per_decode_token": per_token})
    emit({"phase": "e2e", "step": "profile", "traffic": "G", "card": card(),
          "what": "decode_step", **profile_decode(cfg, model.params, prompt,
                                                  16)})
    rows = _teacher_forced(cfg, model.params, prompt, 8)
    _check_teacher_forced("G", rows)
    emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": "G",
          "layout": "unfused", "rows": rows})
    return counts, per_token


def _check_teacher_forced(name, rows):
    for r in rows:
        ok = r["kernel_vs_f32"] <= 2 * r["plain_bf16_vs_f32"] + 1e-3
        check(ok, f"traffic {name} position {r['position']}: kernel "
              f"path {r['kernel_vs_f32']:.3g} vs bf16 twin "
              f"{r['plain_bf16_vs_f32']:.3g} from f32")
        check(math.isfinite(r["kernel_vs_f32"]), "non-finite logits")


def _batched_traffic(cfg, params, name, prompt, cap, kv_quant, reps,
                     expect):
    """Traffic C, D, E or F: decode tok/s as B times the difference
    quotient of a 64- and a 16-token greedy generation (min of ``reps``
    each), prefill seconds, launches per decode step (one token for each
    sequence), held exactly against ``expect`` (kernel -> launches), and a
    profile of 8 decode steps. Returns the launch counts of its run."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape

    def run_gen(n):
        t = time.perf_counter()
        out = gen.generate(cfg, params, prompt, n, max_seq_len=cap,
                           kv_quant=kv_quant).cpu()
        return time.perf_counter() - t, out

    _build.reset_launches()
    steps_s, t16, t64, per_step, out = _quotient(run_gen, 16, 64, reps,
                                                 warm=(16,))
    caches = gen.init_kv_cache(cfg, b, cap, torch.bfloat16, prompt.device,
                               kv_quant=kv_quant)
    t_pre = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen.prefill(cfg, params, prompt, caches)
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t)
    counts = dict(_build.LAUNCHES)
    del caches
    check(out.shape == (b, s + 64) and bool((out[:, s:] >= 0).all())
          and bool((out[:, s:] < cfg.vocab_size).all()),
          f"traffic {name} output")
    for kernel, n in expect.items():
        check(per_step[kernel] == n,
              f"traffic {name}: {per_step[kernel]} {kernel} launches per "
              f"decode step, expected {n}")
    emit({"phase": "e2e", "traffic": name, "card": card(), "batch": b,
          "prompt": s, "cache": "int8" if kv_quant else "bf16",
          "capacity": cap, "decode_tok_s": b * steps_s,
          "t_16_s": t16, "t_64_s": t64, "prefill_s": min(t_pre),
          "prefill_runs_s": t_pre, "prefill_tok_s": b * s / min(t_pre),
          "launches": counts, "launches_per_decode_step": per_step})
    emit({"phase": "e2e", "step": "profile", "traffic": name, "card": card(),
          "what": "decode_step", **profile_decode(cfg, params, prompt, 8,
                                                  kv_quant)})
    return counts, per_step


def _mistral_traffics(dev):
    """Mistral-7B at full width, ``E2E_MISTRAL_DEPTH`` of its 32 layers:
    traffics C (bf16 cache) and D (int8 cache), each followed by its
    teacher-forced check, then H, I, J and K on the same weights."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**dict(MISTRAL, num_hidden_layers=E2E_MISTRAL_DEPTH))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # drawn on the card (the host's numpy draw took ~65 s of the script)
    params = synth_zoo_params(cfg, 0, dev)
    torch.cuda.synchronize()
    emit({"phase": "e2e", "model": "mistral-7b", "step": "synth",
          "layers": cfg.num_hidden_layers,
          "seconds": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(3)
    counts, per_step = {}, {}
    for name, s, cap, kv_quant, reps, tf_steps in (
            ("C", 64, 128, False, 3, 4), ("D", 2048, 2112, True, 2, 2)):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (8, s))).to(dev)
        t0 = time.perf_counter()
        counts[name], per_step[name] = _batched_traffic(
            cfg, params, name, prompt, cap, kv_quant, reps,
            {"fused_attn_step": cfg.num_hidden_layers})
        if name == "D":
            caches = gen.init_kv_cache(cfg, 8, cap, torch.bfloat16, dev,
                                       kv_quant=True)
            emit({"phase": "e2e", "step": "profile", "traffic": name,
                  "card": card(), "what": "prefill", **device_profile(
                      lambda i: gen.prefill(cfg, params, prompt, caches), 1)})
            del caches
        rows = _teacher_forced(cfg, params, prompt, tf_steps, kv_quant)
        _check_teacher_forced(name, rows)
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "layers": cfg.num_hidden_layers,
              "cache": "int8" if kv_quant else "bf16", "rows": rows,
              "seconds": time.perf_counter() - t0})
    counts_p, per_step_p = _paged_traffics(cfg, params, dev)
    counts.update(counts_p)
    per_step.update(per_step_p)
    emit({"phase": "e2e", "model": "mistral-7b",
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts, per_step


def _paged_engine(cfg, params, pool=PAGED_POOL, **kw):
    from autoawq_tpu_torch.serve.paged import PagedBatchingEngine

    return PagedBatchingEngine(cfg, params, **pool, **kw)


def _busy_engine(cfg, params, prompts, **kw):
    """A paged engine with its eight slots admitted (one step, untimed) and
    128 new tokens each to go."""
    import torch

    eng = _paged_engine(cfg, params, **kw)
    for i, p in enumerate(prompts[:8]):
        eng.add_request(i, p, max_new_tokens=128)
    eng.step()
    torch.cuda.synchronize()
    return eng


def _paged_traffic(cfg, params, name, prompts, reps, expect, whole_run,
                   **kw):
    """Traffic H, I or J: steady-state decode tok/s with the eight slots
    busy (8 times the difference quotient of 64 and 16 ``step()`` calls
    after an untimed admission, min of ``reps``), launches per decode step
    held exactly against ``expect``, with ``whole_run`` the 16 requests
    (128 new tokens each) drained by ``run()``, and a profile of 8 steps.
    Returns the launch counts of its runs and the launches per step."""
    import torch

    from autoawq_tpu_torch.ops import _build

    _build.reset_launches()
    t16, t64, per_step = [], [], {}
    for _ in range(reps):
        eng = _busy_engine(cfg, params, prompts, **kw)
        before = dict(_build.LAUNCHES)
        t = time.perf_counter()
        for _ in range(16):
            eng.step()
        t16.append(time.perf_counter() - t)
        mid = dict(_build.LAUNCHES)
        t = time.perf_counter()
        for _ in range(64):
            eng.step()
        t64.append(time.perf_counter() - t)
        after = dict(_build.LAUNCHES)
        per_step = {k: ((after[k] - mid[k]) - (mid[k] - before[k])) / 48
                    for k in after}
        check(sum(r is not None for r in eng.slots) == 8,
              f"traffic {name}: a slot retired inside the timed window")
        busy = eng  # the last one, 47 tokens a slot to go, is profiled
    row = {"phase": "e2e", "traffic": name, "card": card(), "batch": 8,
           "prompt": len(prompts[0]), "pool": PAGED_POOL,
           "kv": "int8" if kw.get("kv_quant") else "bf16",
           "route": kw.get("paged_attn", "bespoke"),
           "steady_decode_tok_s": 8 * 48 / max(min(t64) - min(t16), 1e-9),
           "t_16_steps_s": t16, "t_64_steps_s": t64,
           "launches_per_decode_step": per_step}
    for kernel, n in expect.items():
        check(per_step[kernel] == n,
              f"traffic {name}: {per_step[kernel]} {kernel} launches per "
              f"decode step, expected {n}")
    if whole_run:
        eng = _paged_engine(cfg, params, **kw)
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=128)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run()
        wall = time.perf_counter() - t
        toks = sum(len(v) for v in out.values())
        check(len(out) == len(prompts) and toks == 128 * len(prompts)
              and all(0 <= x < cfg.vocab_size for v in out.values()
                      for x in v), f"traffic {name}: whole-run output")
        row.update(requests=len(prompts), whole_run_s=wall,
                   whole_run_tok_s=toks / wall, stats=eng.stats())
        del eng
    counts = dict(_build.LAUNCHES)
    row["launches"] = counts
    emit(row)
    emit({"phase": "e2e", "step": "profile", "traffic": name, "card": card(),
          "what": "paged decode step (8 slots busy)",
          **device_profile(lambda i: busy.step(), 8)})
    del busy
    return counts, per_step


def _teacher_forced_paged(cfg, params, prompts, steps, **kw):
    """The paged decode step on the kernel path (bf16), the plain path
    (``method="plain"``: the gather and the plain twins, bf16) and the plain
    path in f32, fed the kernel path's greedy tokens: per-step errors
    against f32, as ``_teacher_forced`` gives them. The kernel engine admits
    the eight prompts; the plain engines start from copies of its page
    pool, table and positions (f32 copies for the f32 run's K/V), so the
    three differ only by the decode steps under test. In an MoE model each
    step runs the f32 path first and both bf16 paths replay its expert
    choice (``_RouteTape``), as ``_teacher_forced_moe``'s logit rows do."""
    import torch

    from autoawq_tpu_torch.serve.paged import paged_decode_step

    runs = {"kernel": ("auto", torch.bfloat16),
            "plain": ("plain", torch.bfloat16),
            "plain_f32": ("plain", torch.float32)}
    with torch.inference_mode():
        kern = _paged_engine(cfg, params, **kw)
        for i, p in enumerate(prompts[:8]):
            kern.add_request(i, p, max_new_tokens=steps + 2)
        kern._admit()
        table = kern._h2d(kern.table)
        pages = {}
        for key, (_, dtype) in runs.items():
            pages[key] = [{k: (v.clone() if not v.is_floating_point()
                               or k.endswith("_s")
                               else v.to(dtype, copy=True))
                           for k, v in pc.items()} for pc in kern.pages]
        del kern.pages
        tok = kern._h2d(kern.last_token[:, None])
        pos = kern._h2d(kern.pos)
        route = kern.paged_attn
        rows = []
        tape = _RouteTape(1) if cfg.is_moe else None
        for step in range(steps):
            logits, rec = {}, []
            for key in ("plain_f32", "kernel", "plain"):
                method, dtype = runs[key]
                if tape is not None:
                    tape.reset(**({"record": rec} if key == "plain_f32"
                                  else {"replay": rec}))
                with tape or contextlib.nullcontext():
                    logits[key] = paged_decode_step(
                        cfg, params, tok, pages[key], table, pos, method,
                        dtype, route)[0]
            ref = logits["plain_f32"]
            agree = (logits["kernel"].argmax(-1) == ref.argmax(-1)).float()
            rows.append({"position": int(kern.pos[0]) + step,
                         "kernel_vs_f32": rel_err(logits["kernel"], ref)[1],
                         "plain_bf16_vs_f32": rel_err(logits["plain"],
                                                      ref)[1],
                         "kernel_vs_plain": rel_err(logits["kernel"],
                                                    logits["plain"])[1],
                         "argmax_agree_f32": agree.mean().item()})
            if tape is not None:
                rows[-1]["routing"] = "the f32 run's, replayed"
            tok = logits["kernel"].argmax(-1)[:, None]
            pos = pos + 1
    return rows


def _paged_vs_contiguous(cfg, params, prompts):
    """One decode step of the paged engine's latent pool against the
    contiguous latent cache on the same rows: the engine admits the eight
    prompts (all of one length) on the kernel path, the table's pages are
    gathered into a contiguous ``{"c"}`` cache of the table's capacity, and
    ``generate.decode_step`` runs the same tokens at the same position,
    replaying the paged step's expert choice. Returns max |paged -
    contiguous| / max |contiguous|."""
    import torch

    from autoawq_tpu_torch.ops.paged_attn import gather_slab
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve.paged import paged_decode_step

    with torch.inference_mode():
        eng = _paged_engine(cfg, params)
        for i, p in enumerate(prompts[:8]):
            eng.add_request(i, p, max_new_tokens=4)
        eng._admit()
        table = eng._h2d(eng.table)
        pos = int(eng.pos[0])
        assert (eng.pos == pos).all()
        caches = [{"c": gather_slab(pc["c_pages"], table).clone()}
                  for pc in eng.pages]
        tok = eng._h2d(eng.last_token[:, None])
        rec = []
        with _RouteTape(1) as tape:
            tape.reset(record=rec)
            paged = paged_decode_step(cfg, params, tok, eng.pages, table,
                                      eng._h2d(eng.pos))[0]
            tape.reset(replay=rec)
            contiguous = gen.decode_step(cfg, params, tok, caches, pos)[0]
    return rel_err(paged, contiguous)[1]


def _paged_traffics(cfg, params, dev):
    """Mistral-7B through the paged engine: traffics H (bf16 pool, K7), I
    (int8 pool, K7 folding the scales), J (K9) and K (the HTTP server over
    K's pool). Returns the launch counts of each and H-J's launches per
    decode step."""
    import numpy as np

    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (64,)) for _ in range(16)]
    counts, per_step = {}, {}
    for name, kw, whole_run in (
            ("H", {}, True), ("I", dict(kv_quant=True), False),
            ("J", dict(paged_attn="stock"), False)):
        t0 = time.perf_counter()
        kernel = "paged_attn_stock" if name == "J" else "paged_attn"
        other = "paged_attn" if name == "J" else "paged_attn_stock"
        counts[name], per_step[name] = _paged_traffic(
            cfg, params, name, prompts, 2,
            {kernel: layers, other: 0, "w4a16_gemv": 2 * layers,
             "fused_mlp": layers, "fused_attn_step": 0}, whole_run, **kw)
        rows = _teacher_forced_paged(cfg, params, prompts, 3, **kw)
        _check_teacher_forced(name, rows)
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "layers": layers, "rows": rows,
              "seconds": time.perf_counter() - t0})
    counts["K"] = _serve_traffic(cfg, params)
    return counts, per_step


def _sse_client(port, prompt, max_tokens, out, key, barrier=None):
    """One streamed completion over loopback: token ids, TTFT and total
    seconds into ``out[key]``."""
    import urllib.request

    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_tokens": max_tokens, "stream": True}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=body,
        headers={"Content-Type": "application/json"})
    if barrier is not None:
        barrier.wait()
    t0 = time.perf_counter()
    first, toks = None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.strip()
            if line == b"data: [DONE]":
                break
            if line.startswith(b"data: "):
                ids = json.loads(line[6:])["choices"][0].get("token_ids")
                if ids:
                    first = first or time.perf_counter()
                    toks += ids
    out[key] = {"tokens": toks, "ttft_s": None if first is None
                else first - t0, "total_s": time.perf_counter() - t0}


def _serve_traffic(cfg, params):
    """Traffic K: ``start_server(engine, port=0, burst=16)`` on loopback over
    K's pool; two sequential warm-up clients, then 16 concurrent SSE
    clients, each a shared seeded 256-token system prefix plus its own
    64-token prompt, 64 tokens each (scripts/bench_serve.py's paged
    configuration at Mistral width). The prefix counts are held exactly:
    the first warm-up client's cold admission (M = 320: K2 and K4) caches
    the four system-prompt pages, and every later client reuses them.
    Then ``run(burst=16)`` and ``run(burst=1)`` of eight such requests (32
    new tokens each) give equal greedy streams. Returns the launch counts."""
    import threading

    import numpy as np
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve.server import start_server

    rng = np.random.default_rng(9999)
    system = rng.integers(0, cfg.vocab_size, (256,))
    own = [np.random.default_rng(i).integers(0, cfg.vocab_size, (64,))
           for i in range(20)]
    prompts = [np.concatenate([system, o]) for o in own]
    eng = _paged_engine(cfg, params, pool=SERVE_POOL)
    es, httpd = start_server(eng, port=0, burst=16)
    port = httpd.server_address[1]
    _build.reset_launches()
    warm, out = {}, {}
    try:
        _sse_client(port, prompts[16], 64, warm, "cold")
        cold = dict(_build.LAUNCHES)
        _sse_client(port, prompts[17], 64, warm, "hit")
        st_warm = eng.stats()
        before = dict(_build.LAUNCHES)
        barrier = threading.Barrier(16)
        threads = [threading.Thread(target=_sse_client,
                                    args=(port, prompts[i], 64, out, i,
                                          barrier)) for i in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        st = eng.stats()
        after = dict(_build.LAUNCHES)
    finally:
        httpd.shutdown()
        httpd.server_close()
        es.shutdown()
    layers = cfg.num_hidden_layers
    timed = {k: after[k] - before[k] for k in after}
    check(not any(t.is_alive() for t in threads)
          and len(out) == 16 and all(len(v["tokens"]) == 64
                                     for v in out.values()),
          "traffic K: not every client got its 64 tokens")
    check(st_warm["prefix_hits"] == 1 and st_warm["prefix_pages_reused"] == 4
          and st["prefix_hits"] == 17 and st["prefix_pages_reused"] == 68,
          f"traffic K: prefix counts {st_warm} then {st}, expected 1 / 4 "
          "then 17 / 68 (every timed client reuses the 4 system pages)")
    check(cold["w4a16_gemm"] == 4 * layers
          and cold["prefill_attention"] == layers
          and timed["w4a16_gemm"] == 0 and timed["prefill_attention"] == 0,
          f"traffic K: K2 {cold['w4a16_gemm']} and K4 "
          f"{cold['prefill_attention']} launches in the cold admission, "
          f"{timed['w4a16_gemm']} and {timed['prefill_attention']} after")
    ttft = sorted(v["ttft_s"] for v in out.values() if v["ttft_s"])
    toks = sum(len(v["tokens"]) for v in out.values())
    emit({"phase": "e2e", "traffic": "K", "card": card(), "clients": 16,
          "pool": SERVE_POOL, "burst": 16, "system_prefix": 256,
          "prompt": 64, "max_tokens": 64, "tokens_streamed": toks,
          "wall_s": wall, "throughput_tok_s": toks / wall,
          "ttft_p50_s": ttft[len(ttft) // 2],
          "ttft_p95_s": ttft[max(0, int(len(ttft) * 0.95) - 1)],
          "warmup_ttft_s": {k: v["ttft_s"] for k, v in warm.items()},
          "prefix_hits": st["prefix_hits"],
          "prefix_pages_reused": st["prefix_pages_reused"],
          "launches_cold_admission": cold, "launches_timed": timed})
    del eng
    streams = []
    for burst in (16, 1):
        e = _paged_engine(cfg, params, pool=SERVE_POOL)
        for i in range(8):
            e.add_request(i, prompts[i], max_new_tokens=32)
        streams.append(e.run(burst=burst))
        del e
    torch.cuda.synchronize()
    check(streams[0] == streams[1],
          "traffic K: run(burst=16) and run(burst=1) streams differ")
    emit({"phase": "e2e", "traffic": "K", "step": "burst_vs_single",
          "requests": 8, "equal": streams[0] == streams[1]})
    counts = dict(_build.LAUNCHES)
    return counts


def synth_moe_on_card(cfg, seed, dev):
    """Seeded random W4 g128 Mixtral weights with zero points, drawn on the
    card by a torch.Generator directly in the port's layout: fused qkv, a
    bf16 router (std 0.02, as the JAX synthesiser's), experts stacked. Not
    the JAX synthesiser's draw, whose numpy on the host would take minutes
    at 47 B parameters."""
    import torch

    from autoawq_tpu_torch.utils.synth import synth_qlin

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf = torch.bfloat16
    h, v, ne = cfg.hidden_size, cfg.vocab_size, cfg.num_experts
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    nq = cfg.num_attention_heads * cfg.head_dim_
    nqkv = nq + 2 * cfg.num_key_value_heads * cfg.head_dim_

    def normal(*shape):
        return (torch.randn(*shape, device=dev, generator=gen) * 0.02).to(bf)

    def norm():
        return {"weight": torch.ones(h, dtype=bf, device=dev)}

    params = {"embed_tokens": {"weight": normal(v, h)}, "norm": norm(),
              "lm_head": {"kernel": normal(h, v)}, "layers": []}
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append({
            "input_layernorm": norm(),
            "self_attn": {"qkv_proj": synth_qlin(gen, h, nqkv),
                          "o_proj": synth_qlin(gen, nq, h)},
            "post_attention_layernorm": norm(),
            "mlp": {"gate": {"kernel": normal(h, ne)},
                    "experts_stacked": {
                        "gate_up_proj": synth_qlin(gen, h, 2 * inter,
                                                   experts=ne),
                        "down_proj": synth_qlin(gen, inter, h,
                                                experts=ne)}}})
    return params


def _mixtral_traffics(dev):
    """Mixtral-8x7B at full width: traffics E (bs1) and F (bs8), each with
    K6's launches per decode step held at two per layer, then the
    teacher-forced check with routing record and replay."""
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.serve import generate as gen

    cfg = dataclasses.replace(ModelConfig(**MIXTRAL),
                              num_hidden_layers=MIXTRAL_DEPTH)
    layers = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = synth_moe_on_card(cfg, 0, dev)
    torch.cuda.synchronize()
    nbytes = torch.cuda.memory_allocated()
    emit({"phase": "e2e", "model": "mixtral-8x7b", "step": "synth",
          "layers": layers, "published_layers": MIXTRAL["num_hidden_layers"],
          "cut": f"depth {layers} of {MIXTRAL['num_hidden_layers']} layers, "
          "published width (the script's time limit)",
          "seconds": time.perf_counter() - t0,
          "allocated_bytes_after_synth": nbytes})
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(4)
    counts, per_step = {}, {}
    for name, b, s, cap, tf_steps in (("E", 1, 64, 128, 4),
                                      ("F", 8, 512, 576, 2)):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (b, s))).to(dev)
        t0 = time.perf_counter()
        counts[name], per_step[name] = _batched_traffic(
            cfg, params, name, prompt, cap, False, 3,
            {"moe_gemm": 2 * layers,
             "fused_attn_step": layers if b >= 8 else 0})
        if name == "F":
            caches = gen.init_kv_cache(cfg, b, cap, torch.bfloat16, dev)
            emit({"phase": "e2e", "step": "profile", "traffic": name,
                  "card": card(), "what": "prefill", **device_profile(
                      lambda i: gen.prefill(cfg, params, prompt, caches), 2)})
            del caches
        rows, routing, taps = _teacher_forced_moe(cfg, params, prompt,
                                                  tf_steps)
        _check_teacher_forced(name, rows)
        _check_routing(name, routing)
        emit({"phase": "e2e", "step": "kernel_vs_plain", "traffic": name,
              "layers": layers, "cache": "bf16", "routing": routing,
              "rows": rows, "seconds": time.perf_counter() - t0})
        emit({"phase": "e2e", "step": "moe_block_per_layer", "traffic": name,
              "card": card(), "limit": TOL["moe_block"],
              "rows": _moe_layer_check(cfg, params, name, taps)})
        del taps
    emit({"phase": "e2e", "model": "mixtral-8x7b", "card": card(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts, per_step


class _RouteTape:
    """While entered, ``modules.moe_route`` records each call's expert
    choice (``record``), or replays a recorded one call by call
    (``replay``; ``free`` records the choice the call would have made),
    and keeps the router's input at the calls ``tap_calls`` (``taps``:
    (layer, xt))."""

    def __init__(self, layers):
        self.layers = layers
        self.reset()

    def reset(self, record=None, replay=None, taps=None, tap_calls=(),
              free=None):
        self.record, self.replay, self.taps = record, replay, taps
        self.tap_calls, self.i, self.free = tap_calls, 0, free
        return self

    def __enter__(self):
        from autoawq_tpu_torch.nn import modules

        self.route = modules.moe_route
        modules.moe_route = self
        return self

    def __exit__(self, *exc):
        from autoawq_tpu_torch.nn import modules

        modules.moe_route = self.route

    def __call__(self, cfg_, p, xt, method="auto", topi=None):
        if self.taps is not None and self.i in self.tap_calls:
            self.taps.append((self.i % self.layers, xt.clone()))
        if self.replay is not None:
            if self.free is not None:  # the choice this run would make
                import torch

                with torch.no_grad():
                    self.free.append(self.route(cfg_, p, xt, method)[1])
            topi = self.replay[self.i]
        topw, topi = self.route(cfg_, p, xt, method, topi)
        if self.record is not None:
            self.record.append(topi)
        self.i += 1
        return topw, topi


def _flip_share(runs, ref):
    """Share of (token, layer) top-k sets of ``runs`` that differ from
    ``ref``'s."""
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(runs, ref))
    return diff / max(sum(x.shape[0] for x in ref), 1)


def _teacher_forced_moe(cfg, params, prompt, steps, kv_quant=False):
    """The teacher-forced check of an MoE model. Routing near-ties flip
    between runs that differ only by rounding, and one flipped expert moves
    a token's output far more than rounding does, so this holds two things,
    with ``modules.moe_route`` taped (``_RouteTape``): (a) the share of
    (token, MoE layer) top-k sets that differ from the f32 plain run's, for
    the kernel path and the bf16 plain run, all three on the kernel path's
    greedy tokens; (b) ``_check_teacher_forced``'s logit criterion with
    both bf16 runs replaying the f32 run's choice. ``kv_quant`` gives all
    runs an int8 cache. Returns (per-position rows, routing summary, taps):
    the taps are the kernel path's MoE inputs (layer, [T, H]) at the first
    and last MoE layer of the prefill and of the first decode step, for
    ``_moe_layer_check``."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    moe_layers = [i for i, lp in enumerate(params["layers"])
                  if "experts_stacked" in lp["mlp"]]
    n = len(moe_layers)
    tape = _RouteTape(n)
    tap_calls = (0, n - 1, n, 2 * n - 1)

    def run(method, dtype, tokens):
        """prefill, then ``steps`` decode steps on ``tokens`` (extended
        with its own greedy tokens when it comes empty)."""
        cache = gen.init_kv_cache(cfg, b, s + steps, dtype, prompt.device,
                                  kv_quant=kv_quant)
        logits = [gen.prefill(cfg, params, prompt, cache, method, dtype)[0]]
        greedy = not tokens
        for step in range(steps):
            if greedy:
                tokens.append(logits[-1].argmax(-1)[:, None])
            logits.append(gen.decode_step(cfg, params, tokens[step], cache,
                                          s + step, method, dtype)[0])
        return logits

    bf, f32 = torch.bfloat16, torch.float32
    rec = {"kernel": [], "plain": [], "plain_f32": []}
    tokens, taps = [], []
    with tape:
        tape.reset(record=rec["kernel"], taps=taps, tap_calls=tap_calls)
        free_k = run("auto", bf, tokens)
        tape.reset(record=rec["plain"])
        run("plain", bf, tokens)
        tape.reset(record=rec["plain_f32"])
        ref = run("plain", f32, tokens)
        tape.reset(replay=rec["plain_f32"])
        kern = run("auto", bf, tokens)
        tape.reset(replay=rec["plain_f32"])
        plain = run("plain", bf, tokens)
    taps = [(moe_layers[i], xt) for i, xt in taps]
    routing = {"route_calls": len(rec["plain_f32"]),
               "token_layer_sets": sum(x.shape[0] for x in rec["plain_f32"]),
               "kernel_flip_share": _flip_share(rec["kernel"],
                                                rec["plain_f32"]),
               "plain_bf16_flip_share": _flip_share(rec["plain"],
                                                    rec["plain_f32"])}
    rows = []
    for i in range(steps + 1):
        agree = (kern[i].argmax(-1) == ref[i].argmax(-1)).float().mean()
        rows.append({"position": s + i - 1,
                     "kernel_vs_f32": rel_err(kern[i], ref[i])[1],
                     "plain_bf16_vs_f32": rel_err(plain[i], ref[i])[1],
                     "kernel_vs_plain": rel_err(kern[i], plain[i])[1],
                     "free_routing_kernel_vs_f32": rel_err(free_k[i],
                                                           ref[i])[1],
                     "argmax_agree_f32": agree.item()})
    return rows, routing, taps


def _check_routing(name, routing):
    share_k = routing["kernel_flip_share"]
    share_p = routing["plain_bf16_flip_share"]
    check(share_k <= 2 * share_p + 0.01,
          f"traffic {name}: kernel path flips {share_k:.4f} of the "
          f"(token, layer) expert sets of the f32 run, the bf16 twin "
          f"{share_p:.4f}")


def _moe_layer_check(cfg, params, name, taps):
    """An MoE block held per layer on the hidden states the kernel
    path fed it (``taps``: (layer, xt [T, H])). For each: ``moe_align``'s
    tables on the card equal the CPU's bit for bit (the CPU's are held
    against JAX's by the tests); ``moe_block`` on the card (router,
    ``moe_align``, two K6 launches, the inverse-permutation combine) is
    within ``TOL["moe_block"]`` of a dense f32 reference with the same
    expert choice that shares no routing table, gather or combine with the
    routed path: each chosen expert's MLP in f32 from dequantized weights on
    the tokens that chose it, weighted and summed per token, plus the shared
    experts' MLP in f32 where the layer has them (K8 once at decode-size
    T, held). The bf16 twin's distance from the same reference is printed
    beside it."""
    import torch

    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.ops import moe_gemm as mg
    from autoawq_tpu_torch.ops.fused_mlp import act_fn
    from autoawq_tpu_torch.ops.gemm import dequantize

    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    ne = cfg.num_experts
    route = modules.moe_route
    rows = []

    def expert(lin, e):  # expert e's weight, dequantized to f32 [K, N]
        qz = lin.get("qzeros")
        return dequantize(lin["qweight"][e], lin["scales"][e],
                          None if qz is None else qz[e])

    for layer, xt in taps:
        p = params["layers"][layer]["mlp"]
        st = p["experts_stacked"]
        seen = []

        def recorded(*a, **kw):
            seen.append(route(*a, **kw))
            return seen[-1]

        before = dict(_build.LAUNCHES)
        modules.moe_route = recorded
        try:
            got = modules.moe_block(cfg, p, xt[None]).reshape(xt.shape)
        finally:
            modules.moe_route = route
        launches = _build.LAUNCHES["moe_gemm"] - before["moe_gemm"]
        k8 = _build.LAUNCHES["fused_mlp3"] - before["fused_mlp3"]
        (topw, topi), = seen
        bm = mg.pick_block_m(topi.numel(), ne)
        tables = ("gather_idx", "block_expert", "live_blocks", "entry_rows")
        on_card = mg.moe_align(topi, ne, bm)
        on_cpu = mg.moe_align(topi.cpu(), ne, bm)
        align_equal = {t: torch.equal(a.cpu(), b)
                       for t, a, b in zip(tables, on_card, on_cpu)}
        twin = mg.moe_mlp(st, xt, topw, topi, cfg.hidden_act, inter,
                          method="plain").float()
        sh = p.get("shared_experts")
        if sh is not None:
            twin = twin + modules.mlp(
                cfg, sh, xt[None], "plain",
                intermediate=inter * cfg.n_shared_experts)[0].float()
        x32 = xt.float()
        ref = torch.zeros_like(x32)
        for e in range(ne):
            hit = topi == e
            tok = hit.any(-1).nonzero()[:, 0]
            if tok.numel() == 0:
                continue
            g2 = x32[tok] @ expert(st["gate_up_proj"], e)
            hmid = act_fn(cfg.hidden_act, g2[:, :inter]) * g2[:, inter:]
            y = hmid @ expert(st["down_proj"], e)
            ref[tok] += (topw * hit).sum(-1)[tok, None] * y
        if sh is not None:
            def dense(lin):
                return dequantize(lin["qweight"], lin["scales"],
                                  lin.get("qzeros"))
            hmid = act_fn(cfg.hidden_act, x32 @ dense(sh["gate_proj"])) \
                * (x32 @ dense(sh["up_proj"]))
            ref += hmid @ dense(sh["down_proj"])
        err = rel_err(got, ref)[1]
        twin_err = rel_err(twin, ref)[1]
        where = f"traffic {name} layer {layer} ({xt.shape[0]} tokens)"
        check(launches == 2, f"{where}: {launches} moe_gemm launches in "
              "moe_block, expected 2")
        want_k8 = int(sh is not None and xt.shape[0] <= 32)
        check(k8 == want_k8, f"{where}: {k8} fused_mlp3 launches for the "
              f"shared experts, expected {want_k8}")
        check(all(align_equal.values()), f"{where}: moe_align on the card "
              f"differs from the CPU's: {align_equal}")
        check(err <= TOL["moe_block"], f"{where}: moe_block {err:.4g} of "
              f"the dense f32 reference's maximum, limit {TOL['moe_block']}")
        rows.append({"layer": layer, "tokens": xt.shape[0], "block_m": bm,
                     "live_blocks": int(on_card[2]),
                     "align_equal_cpu": all(align_equal.values()),
                     "kernel_vs_f32": err, "plain_bf16_vs_f32": twin_err,
                     "moe_gemm_launches": launches,
                     "fused_mlp3_launches": k8})
    return rows


def phase_prefill(dev):
    """The prefill kernels and prefills of the checkout under test, for an
    A/B of two checkouts in one call (``--root``, in turns: parent, change,
    change, parent): K2 at B's M=768 gate_up and D's four linears, K4 at B's
    and D's shapes, K6 at F's prefill (kernel times, each call held against
    its twin), then
    traffic B's and D's prefill seconds as the e2e phase times them (host
    clock around one prefill ending in a synchronize; min of 3 after a
    warm-up), on the e2e phase's weights."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import (random_quantized_params,
                                               synth_qlin)

    rng = np.random.default_rng(5)
    torch.manual_seed(5)
    k, n = LINEARS["gate_up"]
    _gemm_case(rng, "w4a16_gemm", "gate_up", 768, k, n, 128, True, dev,
               yardsticks=False)
    for case, (k, n) in D_LINEARS.items():
        _gemm_case(rng, "w4a16_gemm", f"D {case}", D_M, k, n, 128, True, dev,
                   iters=10, yardsticks=False)
    _attn_case(2, 384, 32, 4, 64, dev, yardsticks=False)
    _attn_case(*D_ATTN, dev, iters=10, yardsticks=False, case="D prefill")
    # K6, whose prefill instance runs K2's body, at traffic F's prefill
    draw = torch.Generator(device=dev)
    draw.manual_seed(5)
    h, inter, ne = (MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"],
                    MIXTRAL["num_experts"])
    for case, (k, n) in (("F prefill, gate_up (bm 128)", (h, 2 * inter)),
                         ("F prefill, down (bm 128)", (inter, h))):
        _moe_case(draw, case, synth_qlin(draw, k, n, experts=ne), 4096,
                  dev, iters=10, yardsticks=False)
    for name, model, b, s, cap, kv_quant in (
            ("B", TINYLLAMA, 2, 384, 384 + 32, False),
            ("D", MISTRAL, 8, 2048, 2112, True)):
        cfg = ModelConfig(**model)
        torch.cuda.empty_cache()
        params = fuse_model(cfg, random_quantized_params(
            cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (b, s))).to(dev)
        caches = gen.init_kv_cache(cfg, b, cap, torch.bfloat16, dev,
                                   kv_quant=kv_quant)
        runs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = gen.prefill(cfg, params, prompt, caches)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        check(bool(torch.isfinite(logits).all()),
              f"traffic {name}: non-finite prefill logits")
        emit({"phase": "prefill", "traffic": name, "card": card(),
              "batch": b, "prompt": s, "prefill_s": min(runs[1:]),
              "prefill_runs_s": runs[1:]})
        del params, caches, logits


def phase_paged(dev):
    """The paged decode kernels and steps of the checkout under test, for
    an A/B of two checkouts in one call (``--root``, in turns: parent,
    change, change, parent): K7 at H's and I's shapes and on the long
    table, K9 at J's shape and on the long table (kernel times, each call
    held against its twin), then traffic H's, I's and J's decode step
    with the 8 slots busy, on the e2e phase's Mistral weights: device ms a
    step under torch.profiler over 8 steps (after 4 untimed), with K7's
    or K9's own rows."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.ops import paged_attn as pa
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cases = (("paged_attn", "H: Mistral bf16", {}),
             ("paged_attn", "I: Mistral int8", dict(int8=True)),
             ("paged_attn", "long table: 8 x 4096 rows", LONG_TABLE),
             ("paged_attn_stock", "J: Mistral bf16", {}),
             ("paged_attn_stock", "long table: 8 x 4096 rows", LONG_TABLE))
    for kernel, case, kw in cases:
        _paged_case(gen, kernel, case, MISTRAL, dev, yardsticks=False, **kw)
    if hasattr(pa, "MAX_SPLITS"):  # the split design: other split counts
        default = pa.MAX_SPLITS
        try:
            for most in (64, 32, 8):
                pa.MAX_SPLITS = most
                for kernel, case, kw in cases[2::2]:  # the long tables
                    _paged_case(gen, kernel, f"{case}, at most {most} splits "
                                "a slot", MISTRAL, dev, yardsticks=False, **kw)
        finally:
            pa.MAX_SPLITS = default
    if hasattr(pa, "SPLIT_ROWS"):  # the split design: longer splits
        default = pa.SPLIT_ROWS
        try:
            for rows in (64, 128, 256):
                pa.SPLIT_ROWS = rows
                for kernel, case, kw in (cases[0], cases[1], cases[3]):
                    _paged_case(gen, kernel, f"{case}, splits of {rows} "
                                "rows", MISTRAL, dev, yardsticks=False, **kw)
        finally:
            pa.SPLIT_ROWS = default
    cfg = ModelConfig(**MISTRAL)
    torch.cuda.empty_cache()
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
    rng = np.random.default_rng(5)  # the prompts of _paged_traffics
    prompts = [rng.integers(0, cfg.vocab_size, (64,)) for _ in range(16)]
    for name, kw in (("H", {}), ("I", dict(kv_quant=True)),
                     ("J", dict(paged_attn="stock"))):
        eng = _busy_engine(cfg, params, prompts, **kw)
        for _ in range(4):
            eng.step()
        emit({"phase": "paged", "traffic": name, "card": card(),
              "what": "paged decode step (8 slots busy)",
              **device_profile(lambda i: eng.step(), 8,
                               match=("paged", "combine"))})
        del eng
    del params


# kernel names of K1 and K6 in profiles: K1's instances of the GEMV core
# (DenseJob; K3's and K5's passes are named after their own jobs), K6's
# kernels, and K1's kernel of the earlier design (gemv_kernel), so that one
# list reads both checkouts of an A/B
LINEAR_MATCH = ("DenseJob", "gemv", "moe")
# kernel names of K3, K5 and K8 in profiles: the jobs of this design on the
# GEMV core (ActOut, DownJob, RopeOut, OJob), K5's split kernel over its
# contiguous cache (DenseAddr) and its combine, and the first design's
# CUDA-core passes (under awq::gemv_ and awq::gate_, K5's qkv finish and
# split), so that one list reads both checkouts of an A/B
DECODE_MATCH = ("ActOut", "DownJob", "RopeOut", "OJob", "DenseAddr",
                "attn_combine", "awq::gemv_", "awq::gate_", "qkv_finish",
                "attn_spl")


def phase_linears(dev):
    """K1 and K6 of the checkout under test, for an A/B of two checkouts in
    one call (``--root``, in turns: parent, change, change, parent), each
    call held against its twin: K1 at TinyLlama's four linears at M = 1
    and 8, at Mistral's qkv and o at M = 1, 8 and 64 and at qkv M = 255
    (beside bf16 torch.matmul on the pre-dequantized weight and the byte
    bound); K6 at E's and F's decode (gate_up, down), E's prefill (bm 8)
    and F's prefill (bm 128), beside the per-expert matmuls and the bound;
    controls K2 (B's M=768 gate_up, D's gate_up), K3 and K8 at M=1. Then
    device and host ms of 8 profiled decode steps of A, H (paged engine,
    8 slots busy), E and F, with K1's and K6's profile rows, and F's
    prefill seconds (min of 3 after a warm-up) with a profile of one
    prefill, on the e2e phase's weights."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import (random_quantized_params,
                                               synth_qlin)

    rng = np.random.default_rng(9)
    torch.manual_seed(9)
    for m in (1, 8):
        for case, (k, n) in LINEARS.items():
            _gemm_case(rng, "w4a16_gemv", case, m, k, n, 128, True, dev,
                       plain=False)
    for m in (1, 8, 64):
        for case in ("qkv", "o"):
            k, n = D_LINEARS[case]
            _gemm_case(rng, "w4a16_gemv", f"Mistral {case}", m, k, n, 128,
                       True, dev, plain=False)
    _gemm_case(rng, "w4a16_gemv", "qkv", 255, *LINEARS["qkv"], 128, True,
               dev, plain=False)
    _gemm_case(rng, "w4a16_gemv", "Mistral qkv", 255, *D_LINEARS["qkv"],
               128, True, dev, plain=False)
    _gemm_case(rng, "w4a16_gemm", "gate_up", 768, *LINEARS["gate_up"], 128,
               True, dev, yardsticks=False)
    _gemm_case(rng, "w4a16_gemm", "D gate_up", D_M, *D_LINEARS["gate_up"],
               128, True, dev, iters=10, yardsticks=False)
    _mlp_case(rng, 1, "silu", dev)
    _mlp3_case(rng, "TinyLlama M=1", 1, 2048, 5632, "silu", dev)
    draw = torch.Generator(device=dev)
    draw.manual_seed(9)
    h, inter, ne = (MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"],
                    MIXTRAL["num_experts"])
    gu = synth_qlin(draw, h, 2 * inter, experts=ne)
    dn = synth_qlin(draw, inter, h, experts=ne)
    for case, w, t in (("E decode, gate_up", gu, 1), ("E decode, down", dn, 1),
                       ("F decode, gate_up", gu, 8), ("F decode, down", dn, 8),
                       ("E prefill, gate_up (bm 8)", gu, 64),
                       ("E prefill, down (bm 8)", dn, 64),
                       ("F prefill, gate_up (bm 128)", gu, 4096),
                       ("F prefill, down (bm 128)", dn, 4096)):
        _moe_case(draw, case, w, t, dev, iters=10 if t > 64 else 50,
                  time_plain=False)
    del gu, dn

    def steps(name, cfg, params, prompt):
        emit({"phase": "linears", "traffic": name, "card": card(),
              "what": "decode step", **profile_decode(
                  cfg, params, prompt, 8, match=LINEAR_MATCH)})

    cfg = ModelConfig(**TINYLLAMA)
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 64))).to(dev)  # traffic A's prompt
    steps("A", cfg, params, prompt)
    del params
    cfg = ModelConfig(**MISTRAL)
    torch.cuda.empty_cache()
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
    prng = np.random.default_rng(5)  # the prompts of _paged_traffics
    eng = _busy_engine(cfg, params, [prng.integers(0, cfg.vocab_size, (64,))
                                     for _ in range(16)])
    for _ in range(4):
        eng.step()
    emit({"phase": "linears", "traffic": "H", "card": card(),
          "what": "paged decode step (8 slots busy)",
          **device_profile(lambda i: eng.step(), 8, match=LINEAR_MATCH)})
    del eng, params
    cfg = ModelConfig(**MIXTRAL)
    torch.cuda.empty_cache()
    params = synth_moe_on_card(cfg, 0, dev)
    mrng = np.random.default_rng(4)  # the prompts of _mixtral_traffics
    for name, b, s in (("E", 1, 64), ("F", 8, 512)):
        prompt = torch.from_numpy(mrng.integers(0, cfg.vocab_size,
                                                (b, s))).to(dev)
        steps(name, cfg, params, prompt)
        if name != "F":
            continue
        caches = gen.init_kv_cache(cfg, b, s + 64, torch.bfloat16, dev)
        runs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = gen.prefill(cfg, params, prompt, caches)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        check(bool(torch.isfinite(logits).all()),
              "traffic F: non-finite prefill logits")
        emit({"phase": "linears", "traffic": "F", "card": card(),
              "what": "prefill", "prefill_s": min(runs[1:]),
              "prefill_runs_s": runs[1:], **device_profile(
                  lambda i: gen.prefill(cfg, params, prompt, caches), 1,
                  match=LINEAR_MATCH)})
        del caches, logits
    del params


def phase_decode_mlp_attn(dev):
    """K3, K8 and K5 of the checkout under test, for an A/B of two
    checkouts in one call (``--root``, in turns: parent, change, change,
    parent), each call held against its twin: K3 at TinyLlama's and
    Mistral's decode MLP at M = 1 and 8 and K8 at traffic G's M = 1 and 8
    and a Mixtral expert's M = 1 (beside the unfused chain on K1 and the
    byte bound), K5 at traffic C's and D's last decode
    step (this design's also at D with at most 17 and 33 splits a row and
    kv head: two and one 64-row pages a split); controls K1
    (TinyLlama qkv at M = 1, Mistral qkv and o at M = 8), K2 (B's M = 768
    gate_up), K6 (E's and F's decode gate_up), K7 (H's shape) and K9
    (J's). Then device and host ms of 8 profiled decode steps of A, G, C,
    D and H (paged engine, 8 slots busy) with K3's, K5's and K8's profile
    rows, on the e2e phase's weights and prompts."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.utils.synth import (random_quantized_params,
                                               synth_qlin)

    rng = np.random.default_rng(11)
    torch.manual_seed(11)
    for m in (1, 8):
        _mlp_case(rng, m, "silu", dev)
        _mlp_case(rng, m, "silu", dev, h=MISTRAL["hidden_size"],
                  inter=MISTRAL["intermediate_size"], case="Mistral")
    for m in (1, 8):
        _mlp3_case(rng, f"TinyLlama M={m}", m, 2048, 5632, "silu", dev)
    _mlp3_case(rng, "Mixtral expert M=1", 1, 4096, 14336, "silu", dev)
    _k5_case(rng, "C: Mistral bf16", MISTRAL, 8, 128, 127, dev)
    _k5_case(rng, "D: Mistral int8", MISTRAL, 8, 2112, 2111, dev, int8=True)
    from autoawq_tpu_torch.ops import fused_attn_step as fas
    from autoawq_tpu_torch.ops import paged_attn as pa
    if hasattr(fas, "kv_plan"):  # this design: K5 at D with more splits
        default = pa.MAX_SPLITS
        try:
            for most in (17, 33):  # two and one 64-row pages a split
                pa.MAX_SPLITS = most
                _k5_case(rng, f"D: Mistral int8, at most {most} splits",
                         MISTRAL, 8, 2112, 2111, dev, int8=True)
        finally:
            pa.MAX_SPLITS = default
    _gemm_case(rng, "w4a16_gemv", "qkv", 1, *LINEARS["qkv"], 128, True, dev,
               plain=False)
    for case in ("qkv", "o"):
        _gemm_case(rng, "w4a16_gemv", f"Mistral {case}", 8,
                   *D_LINEARS[case], 128, True, dev, plain=False)
    _gemm_case(rng, "w4a16_gemm", "gate_up", 768, *LINEARS["gate_up"], 128,
               True, dev, yardsticks=False)
    draw = torch.Generator(device=dev)
    draw.manual_seed(11)
    gu = synth_qlin(draw, MIXTRAL["hidden_size"],
                    2 * MIXTRAL["intermediate_size"],
                    experts=MIXTRAL["num_experts"])
    for case, t in (("E decode, gate_up", 1), ("F decode, gate_up", 8)):
        _moe_case(draw, case, gu, t, dev, time_plain=False)
    del gu
    _paged_case(draw, "paged_attn", "H: Mistral bf16", MISTRAL, dev,
                yardsticks=False)
    _paged_case(draw, "paged_attn_stock", "J: Mistral bf16", MISTRAL, dev,
                yardsticks=False)

    def steps(name, cfg, params, prompt, **kw):
        emit({"phase": "decode_mlp_attn", "traffic": name, "card": card(),
              "what": "decode step", **profile_decode(
                  cfg, params, prompt, 8, match=DECODE_MATCH, **kw)})

    cfg = ModelConfig(**TINYLLAMA)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 64))).to(dev)  # traffic A's (and G's) prompt
    params = random_quantized_params(cfg, seed=0, fp_dtype=torch.bfloat16,
                                     device=dev)
    steps("G", cfg, params, prompt)  # unfused gate / up: K8
    steps("A", cfg, fuse_model(cfg, params), prompt)
    del params
    cfg = ModelConfig(**MISTRAL)
    torch.cuda.empty_cache()
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=dev))
    crng = np.random.default_rng(3)  # the prompts of _mistral_traffics
    for name, s, kv_quant in (("C", 64, False), ("D", 2048, True)):
        prompt = torch.from_numpy(crng.integers(0, cfg.vocab_size,
                                                (8, s))).to(dev)
        steps(name, cfg, params, prompt, kv_quant=kv_quant)
    prng = np.random.default_rng(5)  # the prompts of _paged_traffics
    eng = _busy_engine(cfg, params, [prng.integers(0, cfg.vocab_size, (64,))
                                     for _ in range(16)])
    for _ in range(4):
        eng.step()
    emit({"phase": "decode_mlp_attn", "traffic": "H", "card": card(),
          "what": "paged decode step (8 slots busy)",
          **device_profile(lambda i: eng.step(), 8, match=DECODE_MATCH)})
    del eng, params


def phase_attn_bwd(dev):
    """K10 and K11 of the checkout under test, for an A/B of two checkouts
    in one call (``--root``, in turns: parent, change, change, parent): at
    traffic W's step (B=4, S=512, 32/8 heads, hd 128), TinyLlama's heads
    and GPT-J's hd 256, each held against the twin's gradients and timed
    with its bound; then traffic W's step ms (min of 3 after a warm-up) on
    W's weights, as the train phase builds them (Mistral at full width and
    depth, rank-8 adapters on q/k/v/o, 4 x 512 seeded ids, bf16, AdamW)."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.train import lora
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    _build.build_all(("prefill_attention", "prefill_attention_bwd",
                      "w4a16_gemm"))
    torch.manual_seed(15)
    for case, shape in (("W: Mistral", TRAIN_ATTN),
                        ("TinyLlama", (2, 384, 32, 4, 64)),
                        ("GPT-J hd 256", (2, 384, 16, 16, 256))):
        _attn_bwd_case(case, *shape, dev, yardsticks=False)
    cfg = ModelConfig(**MISTRAL)
    torch.cuda.empty_cache()
    params = _unfused(cfg, synth_zoo_params(cfg, 0, dev))
    lora.add_lora(cfg, params, rank=TRAIN_RANK, seed=0)
    adapters, base = lora.split_lora(params)
    opt = lora.make_optimizer(adapters, "adamw", lr=TRAIN_LR)
    tokens = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab_size, TRAIN_BATCH)).to(dev)
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = lora.lora_train_step_opt(cfg, adapters, base, opt, tokens,
                                        dtype=torch.bfloat16).item()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    check(math.isfinite(loss), f"attn_bwd: W step loss {loss}")
    emit({"phase": "attn_bwd", "traffic": "W", "card": card(),
          "step_ms_min": min(runs[1:]), "step_ms": runs[1:], "loss": loss})
    del adapters, base, params, opt
    torch.cuda.empty_cache()


def phase_load(dev):
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch import AutoAWQForCausalLM
    from autoawq_tpu_torch.core.packing import pack_awq, pack_port
    from autoawq_tpu_torch.io.safetensors import save_file
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.ops._build import BUILD_DIR

    cfg = dataclasses.replace(ModelConfig(**TINYLLAMA), num_hidden_layers=2)
    rng = np.random.default_rng(2)
    gs = 128
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim_
    shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, kv),
              "self_attn.v_proj": (h, kv), "self_attn.o_proj": (h, h),
              "mlp.gate_proj": (h, inter), "mlp.up_proj": (h, inter),
              "mlp.down_proj": (inter, h)}
    sd, mem = {}, {"layers": []}
    emb = (rng.standard_normal((v, h)) * 0.02).astype(np.float16)
    head = (rng.standard_normal((v, h)) * 0.02).astype(np.float16)
    sd["model.embed_tokens.weight"] = emb
    sd["model.norm.weight"] = np.ones(h, np.float16)
    sd["lm_head.weight"] = head
    bf = torch.bfloat16
    mem["embed_tokens"] = {"weight": torch.from_numpy(emb).to(dev, bf)}
    mem["norm"] = {"weight": torch.ones(h, device=dev, dtype=bf)}
    mem["lm_head"] = {"kernel": torch.from_numpy(head.T.copy()).to(dev, bf)}
    for i in range(cfg.num_hidden_layers):
        lp = {"input_layernorm": {"weight": torch.ones(h, device=dev,
                                                       dtype=bf)},
              "post_attention_layernorm": {"weight": torch.ones(
                  h, device=dev, dtype=bf)},
              "self_attn": {}, "mlp": {}}
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{i}.{n}.weight"] = np.ones(h, np.float16)
        for role, (k, n) in shapes.items():
            q4 = rng.integers(0, 16, (k, n))
            z4 = rng.integers(0, 16, (k // gs, n))
            sc = ((rng.random((k // gs, n)) + 0.5) * 0.01).astype(np.float16)
            pre = f"model.layers.{i}.{role}"
            sd[pre + ".qweight"] = pack_awq(q4)
            sd[pre + ".qzeros"] = pack_awq(z4)
            sd[pre + ".scales"] = sc
            grp, name = role.split(".")
            lp[grp][name] = {
                "qweight": pack_port(q4).to(dev),
                "scales": torch.from_numpy(sc.astype(np.float32)).to(dev),
                "qzeros": pack_port(z4).to(dev)}
        mem["layers"].append(lp)
    path = os.path.join(BUILD_DIR, "smoke_ckpt")
    os.makedirs(path, exist_ok=True)
    try:
        hf = cfg.to_hf_dict()
        hf["quantization_config"] = {"quant_method": "awq", "bits": 4,
                                     "group_size": gs, "zero_point": True,
                                     "version": "gemm"}
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf, f)
        save_file(sd, os.path.join(path, "model.safetensors"))
        models, t_load = {}, {}
        for fused in (False, True):  # the facade's default first
            t = time.perf_counter()
            models[fused] = AutoAWQForCausalLM.from_quantized(
                path, fuse_layers=fused)
            t_load[fused] = time.perf_counter() - t
    finally:
        shutil.rmtree(path, ignore_errors=True)
    prompt = torch.from_numpy(rng.integers(0, v, (1, 16))).to(dev)
    for fused in (False, True):
        model = models[fused]
        if fused:
            mem = fuse_model(cfg, mem)
        launches = []
        for n in (4, 8):
            _build.reset_launches()
            out = model.generate(prompt, max_new_tokens=n)
            launches.append(dict(_build.LAUNCHES))
        per_step = {k: (launches[1][k] - launches[0][k]) / 4
                    for k in launches[0]}
        with torch.inference_mode():
            got = model(prompt, dtype=bf)
            ref = modules.forward(cfg, mem, prompt, dtype=bf)
        err = (got - ref).abs().max().item()
        layout = "fused" if fused else "unfused"
        # same nibbles, same kernels, deterministic reductions: exact
        check(err == 0.0, f"load ({layout}): logits differ from the "
              f"in-memory model by {err}")
        check(out.shape == (1, 24), f"load ({layout}): generate output shape")
        check(bool(torch.isfinite(got).all()),
              f"load ({layout}): non-finite logits")
        mlp_kernel = "fused_mlp" if fused else "fused_mlp3"
        check(per_step[mlp_kernel] == cfg.num_hidden_layers,
              f"load ({layout}): {per_step[mlp_kernel]} {mlp_kernel} "
              f"launches per decode step, expected {cfg.num_hidden_layers}")
        emit({"phase": "load", "layout": layout,
              "layers": cfg.num_hidden_layers, "load_s": t_load[fused],
              "max_abs_err": err, "launches_per_decode_step": per_step,
              "new_tokens": out[0, 16:].tolist()})


def _outlier_fp(cfg, dev):
    """Seeded f32 float weights of a llama-family model drawn on the card
    (``synth_float_on_card``, seed 0: std 0.05 and norms of ones, as
    ``io/hf.init_random_params``, and the hot embedding columns 0-5 x 8 of
    ``tests/test_quantizer.make_outlier_params``), with q / k / v apart as
    the llama plugin quantizes them. A numpy draw on the host took ~20 s
    at TinyLlama's size."""
    params = synth_float_on_card(cfg, 0, dev)
    hd, nh, nkv = (cfg.head_dim_, cfg.num_attention_heads,
                   cfg.num_key_value_heads)
    for lp in params["layers"]:
        w = lp["self_attn"].pop("qkv_proj")["kernel"]
        for name, lo, hi in (("q", 0, nh), ("k", nh, nh + nkv),
                             ("v", nh + nkv, nh + 2 * nkv)):
            lp["self_attn"][f"{name}_proj"] = {
                "kernel": w[:, lo * hd:hi * hd].contiguous()}
    return params


def _rtn(cfg, params, qcfg):
    """Round-to-nearest (no search) of every linear AWQ quantizes (the
    plugin's ``quantizable``: an MoE router stays float), AWQ's
    baseline."""
    from autoawq_tpu_torch.models.plugins import get_plugin
    from autoawq_tpu_torch.quantize.quantizer import (_clone,
                                                      quantize_linear_params)
    from autoawq_tpu_torch.utils.tree import get_by_path, set_by_path

    out = {**params, "layers": []}
    for lp in params["layers"]:
        lq = _clone(lp)
        for path in get_plugin(cfg.model_type).quantizable(cfg, lq):
            set_by_path(lq, path, quantize_linear_params(
                get_by_path(lq, path), qcfg))
        out["layers"].append(lq)
    return out


def _quant_timings(q, seconds):
    parts = dict(q.timings)
    parts["other"] = seconds - sum(parts.values())
    return parts


def phase_quantize(dev):
    """AWQ on the card: TinyLlama at full width and depth quantized, saved,
    reloaded and served through K1-K4; AWQ against round-to-nearest on
    held-out tokens sampled from the float model; Mistral-7B at full width,
    depth cut, for the seconds a layer; MPT-7B, depth cut, quantized,
    saved, reloaded and served through K1, K2 and K7, with its quality
    gate; GPT-J-6B, depth cut, for the seconds a layer. Returns the launch
    counts of the served checkpoints' runs."""
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.io import serialize
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.ops._build import BUILD_DIR

    qcfg = AwqConfig(q_group_size=128, zero_point=True)
    cfg = ModelConfig(**TINYLLAMA)
    calib = np.random.default_rng(1).integers(0, cfg.vocab_size, QUANT_CALIB)
    t = time.perf_counter()
    fp = _outlier_fp(cfg, dev)
    torch.cuda.synchronize()
    emit({"phase": "quantize", "step": "synth", "model": "tinyllama",
          "layers": cfg.num_hidden_layers,
          "seconds": time.perf_counter() - t})

    # [1] quantize through the facade, on the card
    torch.cuda.reset_peak_memory_stats()
    model = AwqCausalLM(cfg, fp, device=dev)
    t = time.perf_counter()
    model.quantize(calib_data=calib, quant_config=qcfg,
                   max_calib_samples=QUANT_CALIB[0],
                   max_calib_seq_len=QUANT_CALIB[1], progress=False,
                   quantize_lm_head=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    q = model._quantizer
    # the head is quantized after every layer, from the last layer's
    # stream, so the head-float model of [2] and [3] is these layers with
    # the float head; [3b] serves the quantized head
    head_q = model.params["lm_head"]
    model.params["lm_head"] = fp["lm_head"]
    check("qweight" in head_q, "quantize: lm_head not quantized")
    emit({"phase": "quantize", "step": "quantize", "model": "tinyllama",
          "layers": cfg.num_hidden_layers, "calib": list(QUANT_CALIB),
          "recipe": "g128, zero point, scale and clip search, f32; "
                    "quantize_lm_head (the head's clip search and packing "
                    "in the seconds)",
          "seconds": seconds, "seconds_by_part": _quant_timings(q, seconds),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "layer0_ratio_index": _ratio_indices(q)})
    check(all(math.isfinite(v) for v in q.timings.values()),
          "quantize: timings")

    # [2] save, reload bit for bit, serve through K1-K4
    path = os.path.join(BUILD_DIR, "quant_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    try:
        t = time.perf_counter()
        model.save_quantized(path)
        t_save = time.perf_counter() - t
        _, _, loaded = serialize.from_quantized(path, dev)
        mismatched = _reload_mismatches(model.params, loaded)
        check(not mismatched, f"quantize: reloaded tensors differ at "
              f"{mismatched[:4]}")
        del loaded
        t = time.perf_counter()
        served = AwqCausalLM.from_quantized(path, fuse_layers=True,
                                            device=dev)
        t_load = time.perf_counter() - t
    finally:
        shutil.rmtree(path, ignore_errors=True)
    rng = np.random.default_rng(0)
    prompt_b = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (2, 384))).to(dev)
    prompt_a = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, 64))).to(dev)
    _build.reset_launches()
    out_b = served.generate(prompt_b, max_new_tokens=1)
    out_a = served.generate(prompt_a, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    check(out_b.shape == (2, 385) and out_a.shape == (1, 96),
          "quantize: served output shapes")
    for name in ("w4a16_gemv", "w4a16_gemm", "fused_mlp",
                 "prefill_attention"):
        check(counts[name] > 0, f"quantize: the served checkpoint never "
              f"launched {name}")
    emit({"phase": "quantize", "step": "serve", "save_s": t_save,
          "load_s": t_load, "bit_equal_linears": not mismatched,
          "packer": "native (core/native)",
          "launches": counts, "new_tokens": out_a[0, 64:].tolist()})
    # [2b] the same model saved as gemv and gemv_fast, and a symmetric
    # (zero_point=False, round-to-nearest) one as GEMM and marlin: each
    # reload's greedy stream equals its GEMM checkpoint's
    _version_checks(cfg, model.params, qcfg, out_a, prompt_a,
                    ("gemv", "gemv_fast"), dev)
    sym_qcfg = dataclasses.replace(qcfg, zero_point=False)
    sym = _rtn(cfg, fp, sym_qcfg)
    path = os.path.join(BUILD_DIR, "quant_ckpt")
    try:
        AwqCausalLM(cfg, sym, sym_qcfg, device=dev).save_quantized(path)
        sym_out = AwqCausalLM.from_quantized(
            path, fuse_layers=True, device=dev).generate(
                prompt_a, max_new_tokens=32)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    _version_checks(cfg, sym, sym_qcfg, sym_out, prompt_a, ("marlin",), dev)
    del sym
    for name, prompt, steps in (("Q-A", prompt_a, 8), ("Q-B", prompt_b, 1)):
        rows = _teacher_forced(cfg, served.params, prompt, steps)
        _check_teacher_forced(name, rows)
        emit({"phase": "quantize", "step": "kernel_vs_plain",
              "traffic": name, "rows": rows})
    del served

    # [3] quality: AWQ against round-to-nearest, against the float model
    held = _quality("tinyllama", cfg, fp, model.params, qcfg, dev)
    # [3b] the quantized head: KL against the head-float model, saved and
    # reloaded, one K1 launch a decode step
    _head_checks(cfg, model.params, head_q, qcfg, held, prompt_a, dev)
    del model, fp, q, head_q
    # [3c] per-layer calibration resume: TinyLlama at full width, 2 layers
    # on 32 x 512 ids, run, then run again over its own files
    _resume_check(dataclasses.replace(cfg, num_hidden_layers=2), calib[:32],
                  qcfg, dev)

    # [4] Mistral-7B at full width, depth cut: seconds a layer
    mcfg = dataclasses.replace(ModelConfig(**MISTRAL),
                               num_hidden_layers=QUANT_MISTRAL_LAYERS)
    _quantize_cut("mistral-7b", mcfg, MISTRAL["num_hidden_layers"],
                  _outlier_fp(mcfg, dev), calib, qcfg, dev)

    # [5] MPT-7B at full width, depth cut: quantized, saved, reloaded, served
    mpt_counts = _quantize_mpt(qcfg, dev)
    counts = {k: n + mpt_counts.get(k, 0) for k, n in counts.items()}

    # [6] GPT-J-6B at full width, depth cut: the whole-block inspect
    published = ModelConfig.from_hf_dict(GPTJ_6B)
    gcfg = dataclasses.replace(published,
                               num_hidden_layers=QUANT_GPTJ_LAYERS)
    torch.cuda.empty_cache()
    gfp = synth_float_on_card(gcfg, 0, dev)
    out = _quantize_cut("gpt-j-6b", gcfg, published.num_hidden_layers, gfp,
                        np.random.default_rng(1).integers(
                            0, gcfg.vocab_size, QUANT_CALIB), qcfg, dev)
    check(all("act_scale" in lp["mlp"] for lp in out["layers"]),
          "quantize: GPT-J's fc2 scaled against no activation")
    del out, gfp

    # [7] DeepSeek-V2-Lite at full width, depth cut: MLA and MoE quantized,
    # saved, reloaded, served
    v2_counts = _quantize_v2_lite(dev)
    return {k: n + v2_counts.get(k, 0) for k, n in counts.items()}


def _ratio_indices(q):
    """Layer 0's chosen grid index for each scale group."""
    return {f"{c['group'].prev_op}->{','.join(c['group'].layers)}": c["best"]
            for c in q.scale_choices[0]}


def _reload_mismatches(mem, loaded):
    """Paths where a reloaded tree's nibbles, zeros, scales or
    ``act_scale`` differ from the in-memory quantized tree's (its scales
    rounded to fp16, as the checkpoint holds them)."""
    import torch

    from autoawq_tpu_torch.utils.tree import get_by_path, iter_linears

    bad = []
    for i, (lm, ll) in enumerate(zip(mem["layers"], loaded["layers"])):
        for lin_path, p in iter_linears(lm):
            lq = get_by_path(ll, lin_path)
            if "qweight" not in p:
                continue
            same = (torch.equal(lq["qweight"], p["qweight"])
                    and torch.equal(lq["qzeros"], p["qzeros"])
                    and torch.equal(lq["scales"],
                                    p["scales"].half().float()))
            if not same:
                bad.append(f"{i}.{lin_path}")
        act = lm["mlp"].get("act_scale")
        if (act is None) != ("act_scale" not in ll["mlp"]) or (
                act is not None and not torch.equal(
                    ll["mlp"]["act_scale"], act.half().float())):
            bad.append(f"{i}.mlp.act_scale")
    return bad


def _quality(name, cfg, fp, params, qcfg, dev):
    """AWQ against round-to-nearest, against the float model, on
    ``QUANT_EVAL`` held-out tokens sampled from it at temperature 1
    (scripts/quality.py): KL report and perplexity of each; AWQ's mean KL
    must be below RTN's."""
    import torch

    from autoawq_tpu_torch.eval.perplexity import (kl_divergence_report,
                                                   perplexity)
    from autoawq_tpu_torch.serve import generate as gen

    t = time.perf_counter()
    bos = torch.zeros((QUANT_EVAL[0], 1), dtype=torch.long, device=dev)
    held = gen.generate(cfg, fp, bos, QUANT_EVAL[1], temperature=1.0,
                        seed=13, method="plain", dtype=torch.float32)[:, 1:]
    t_sample = time.perf_counter() - t
    stream = held.reshape(-1).cpu().numpy()
    kw = dict(seq_len=QUANT_EVAL[1], method="plain")
    ppl_fp = perplexity(cfg, fp, stream, **kw)
    quality = {"sample_s": t_sample, "eval_tokens": list(QUANT_EVAL),
               "fp_ppl": ppl_fp}
    for method, q in (("awq", params), ("rtn", _rtn(cfg, fp, qcfg))):
        rep = kl_divergence_report(cfg, fp, cfg, q, held.cpu().numpy(),
                                   method="plain")
        ppl = perplexity(cfg, q, stream, **kw)
        quality[method] = {"ppl": ppl, "delta_ppl": ppl - ppl_fp, **rep}
    check(quality["awq"]["kl_mean"] < quality["rtn"]["kl_mean"],
          f"quantize: {name}: AWQ's mean KL {quality['awq']['kl_mean']:.4g} "
          f"is not below RTN's {quality['rtn']['kl_mean']:.4g}")
    check(all(math.isfinite(quality[k]["ppl"]) for k in ("awq", "rtn"))
          and math.isfinite(ppl_fp), f"quantize: {name}: non-finite "
          "perplexity")
    emit({"phase": "quantize", "step": "quality", "model": name, **quality})
    return held


def _version_checks(cfg, params, qcfg, want, prompt, versions, dev):
    """``params`` saved in each AutoAWQ version and reloaded (fused): the
    greedy stream of ``prompt`` equals ``want`` (its GEMM checkpoint's),
    with the save / load seconds."""
    import dataclasses

    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.ops._build import BUILD_DIR

    for version in versions:
        vq = dataclasses.replace(qcfg, version=version)
        path = os.path.join(BUILD_DIR, f"quant_ckpt_{version}")
        shutil.rmtree(path, ignore_errors=True)
        try:
            t = time.perf_counter()
            AwqCausalLM(cfg, params, vq, device=dev).save_quantized(path)
            t_save = time.perf_counter() - t
            t = time.perf_counter()
            served = AwqCausalLM.from_quantized(path, fuse_layers=True,
                                                device=dev)
            t_load = time.perf_counter() - t
            check(served.quant_config.version == version,
                  f"quantize: {version} checkpoint read as "
                  f"{served.quant_config.version}")
        finally:
            shutil.rmtree(path, ignore_errors=True)
        got = served.generate(prompt, max_new_tokens=want.shape[1]
                              - prompt.shape[1])
        same = bool(torch_equal(got, want))
        check(same, f"quantize: the {version} checkpoint's greedy stream "
              "differs from the GEMM checkpoint's")
        emit({"phase": "quantize", "step": "version", "version": version,
              "zero_point": qcfg.zero_point, "save_s": t_save,
              "load_s": t_load, "stream_equal_gemm": same})
        del served


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def _head_checks(cfg, params, head_q, qcfg, held, prompt, dev):
    """The quantized lm_head (``quantize_lm_head``): KL of the model with
    it against the head-float model on the held-out tokens; saved and
    reloaded with its nibbles, zeros and (fp16) scales; served, with one K1
    launch a decode step for the head."""
    import torch

    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.eval.perplexity import kl_divergence_report
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.ops._build import BUILD_DIR

    hq = {**params, "lm_head": head_q}
    rep = kl_divergence_report(cfg, params, cfg, hq, held.cpu().numpy(),
                               method="plain")
    path = os.path.join(BUILD_DIR, "quant_ckpt_head")
    shutil.rmtree(path, ignore_errors=True)
    try:
        AwqCausalLM(cfg, hq, qcfg, device=dev).save_quantized(path)
        served = AwqCausalLM.from_quantized(path, fuse_layers=True,
                                            device=dev)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    back = served.params["lm_head"]
    same = (torch.equal(back["qweight"], head_q["qweight"])
            and torch.equal(back["qzeros"], head_q["qzeros"])
            and torch.equal(back["scales"], head_q["scales"].half().float()))
    check(same, "quantize: the reloaded lm_head differs")
    launches = []
    for n in (4, 8):
        _build.reset_launches()
        served.generate(prompt, max_new_tokens=n)
        launches.append(dict(_build.LAUNCHES))
    per_step = {k: (launches[1][k] - launches[0][k]) / 4
                for k in launches[0]}
    expect = 2 * cfg.num_hidden_layers + 1  # qkv and o a layer, the head
    check(per_step["w4a16_gemv"] == expect,
          f"quantize: {per_step['w4a16_gemv']} K1 launches a decode step "
          f"with the quantized head, expected {expect}")
    check(math.isfinite(rep["kl_mean"]), "quantize: head KL not finite")
    emit({"phase": "quantize", "step": "lm_head", "model": "tinyllama",
          "kl_vs_head_float": rep, "reload_equal": same,
          "launches_per_decode_step": per_step})
    del served


def _resume_check(cfg, calib, qcfg, dev):
    """A ``resume_dir`` run, then the same run over its own files: every
    layer read back (no layer searched), the tree exactly equal, and both
    runs' seconds."""
    import torch

    from autoawq_tpu_torch.ops._build import BUILD_DIR
    from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer

    path = os.path.join(BUILD_DIR, "resume")
    shutil.rmtree(path, ignore_errors=True)
    fp = _outlier_fp(cfg, dev)
    outs, secs, searched = [], [], []
    try:
        for _ in range(2):
            q = AwqQuantizer(cfg, qcfg, fp, calib, progress=False,
                             keep_on_device=True, resume_dir=path,
                             device=dev)
            t = time.perf_counter()
            outs.append(q.quantize())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            searched.append(len(q.all_scales))
        files = sorted(os.listdir(path))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    same = _trees_equal(outs[0], outs[1])
    check(searched == [cfg.num_hidden_layers, 0] and same
          and len(files) == cfg.num_hidden_layers,
          f"quantize: resume: layers searched {searched}, files {files}, "
          f"trees equal {same}")
    emit({"phase": "quantize", "step": "resume", "model": "tinyllama",
          "layers": cfg.num_hidden_layers, "calib": list(calib.shape),
          "first_s": secs[0], "resumed_s": secs[1],
          "layers_searched": searched, "tree_equal": same})


def _trees_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b)))
    return a == b


def _quantize_cut(name, cfg, published_layers, fp, calib, qcfg, dev):
    """The quantizer alone on a model cut in depth: seconds a layer, by
    part, peak memory, layer 0's chosen ratio indices. Returns the
    quantized tree (on the card)."""
    import torch

    from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
    from autoawq_tpu_torch.utils.tree import iter_linears

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    q = AwqQuantizer(cfg, qcfg, fp, calib, progress=False,
                     keep_on_device=True, device=dev)
    t = time.perf_counter()
    out = q.quantize()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    check(all("qweight" in p for lp in out["layers"]
              for _, p in iter_linears(lp)), f"quantize: {name} not packed")
    emit({"phase": "quantize", "step": "quantize", "model": name,
          "layers": cfg.num_hidden_layers, "card": card(),
          "depth_cut": f"{cfg.num_hidden_layers} of {published_layers} "
                       "layers, published width",
          "calib": list(QUANT_CALIB), "seconds": seconds,
          "seconds_per_layer": seconds / cfg.num_hidden_layers,
          "seconds_by_part": _quant_timings(q, seconds),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "layer0_ratio_index": _ratio_indices(q)})
    return out


def _saved_keys(path):
    """The tensor names of a checkpoint directory, from the safetensors
    headers alone (an 8-byte little-endian length, then JSON)."""
    keys = set()
    for name in os.listdir(path):
        if name.endswith(".safetensors"):
            with open(os.path.join(path, name), "rb") as f:
                n = int.from_bytes(f.read(8), "little")
                keys.update(json.loads(f.read(n)))
    keys.discard("__metadata__")
    return keys


def _quantize_mpt(qcfg, dev):
    """MPT-7B at full width, depth ``QUANT_MPT_LAYERS``: float weights drawn
    on the card, quantized through the facade, saved (every layer's
    ``ffn.act.scales`` in the files), reloaded exactly, served through K1,
    K2 and K7 with its launches held, and gated on AWQ's KL below RTN's.
    Returns the launch counts of the served model's checks."""
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.api import cast_params
    from autoawq_tpu_torch.io.hf import get_layout
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops._build import BUILD_DIR

    published = ModelConfig.from_hf_dict(MPT7B)
    cfg = dataclasses.replace(published, num_hidden_layers=QUANT_MPT_LAYERS)
    layers = cfg.num_hidden_layers
    cut = (f"{layers} of {published.num_hidden_layers} layers, published "
           "width")
    calib = np.random.default_rng(1).integers(0, cfg.vocab_size, QUANT_CALIB)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    fp = synth_float_on_card(cfg, 0, dev)
    torch.cuda.synchronize()
    emit({"phase": "quantize", "step": "synth", "model": "mpt-7b",
          "layers": layers, "depth_cut": cut,
          "seconds": time.perf_counter() - t})

    torch.cuda.reset_peak_memory_stats()
    model = AwqCausalLM(cfg, fp, device=dev)
    t = time.perf_counter()
    model.quantize(calib_data=calib, quant_config=qcfg,
                   max_calib_samples=QUANT_CALIB[0],
                   max_calib_seq_len=QUANT_CALIB[1], progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    q = model._quantizer
    emit({"phase": "quantize", "step": "quantize", "model": "mpt-7b",
          "layers": layers, "depth_cut": cut, "card": card(),
          "calib": list(QUANT_CALIB),
          "recipe": "g128, zero point, scale and clip search, f32",
          "seconds": seconds, "seconds_per_layer": seconds / layers,
          "seconds_by_part": _quant_timings(q, seconds),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "layer0_ratio_index": _ratio_indices(q)})
    check(all("act_scale" in lp["mlp"] for lp in model.params["layers"]),
          "quantize: MPT's fc2 scaled against no activation")

    path = os.path.join(BUILD_DIR, "quant_mpt")
    shutil.rmtree(path, ignore_errors=True)
    try:
        t = time.perf_counter()
        model.save_quantized(path)
        t_save = time.perf_counter() - t
        keys = _saved_keys(path)
        act = get_layout(cfg.model_type).act
        missing = [i for i in range(layers)
                   if f"transformer.blocks.{i}.{act}.scales" not in keys]
        check(not missing, f"quantize: MPT's saved files lack the act "
              f"scales of layers {missing}")
        # loaded once, in the checkpoint's dtypes (fusing leaves MPT's
        # layout as it is), held exactly, then cast to bf16 to serve, as
        # the default dtype would have cast it
        t = time.perf_counter()
        served = AwqCausalLM.from_quantized(path, fuse_layers=True,
                                            device=dev, dtype=None)
        t_load = time.perf_counter() - t
    finally:
        shutil.rmtree(path, ignore_errors=True)
    mismatched = _reload_mismatches(model.params, served.params)
    check(not mismatched, f"quantize: MPT's reloaded tensors differ at "
          f"{mismatched[:4]}")
    served.params = cast_params(served.params, torch.bfloat16)
    emit({"phase": "quantize", "step": "save_load", "model": "mpt-7b",
          "save_s": t_save, "load_s": t_load,
          "act_scales_saved": layers - len(missing),
          "reloaded_equal": not mismatched})
    counts = _served_checks(
        "quantize", "mpt-7b quantized", cfg, served.params, dev,
        np.random.default_rng(11),
        {"w4a16_gemv": 4 * layers, "fused_mlp": 0, "fused_attn_step": 0},
        {"w4a16_gemm": 4 * layers, "prefill_attention": 0,
         "w4a16_gemv": 0},
        {"w4a16_gemv": 4 * layers, "paged_attn": layers,
         "paged_attn_stock": 0})
    del served
    _quality("mpt-7b", cfg, fp, model.params, qcfg, dev)
    return counts


def _quantize_v2_lite(dev):
    """DeepSeek-V2-Lite at full width, depth ``V2_LITE_QUANT_LAYERS`` (layer
    0 dense at 10,944, then one MoE layer of 64 routed experts top-6 and 2
    shared): float weights drawn on the card with hot embedding columns,
    quantized at g64 through the facade on ``V2_LITE_CALIB`` seeded ids
    (the dense ``moe`` inspect runs all 64 experts on every token), gated
    on AWQ's KL below RTN's, saved, reloaded exactly with kv_b's dense leaf
    on both sides, and served fused: one decode step with its launches held
    exactly (K1 3 a layer, K3 for layer 0, K6 2 and K8 1 for the MoE
    layer), 16 teacher-forced bs1 steps with the f32 expert choice
    replayed. Returns the served model's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.api import cast_params
    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.ops._build import BUILD_DIR
    from autoawq_tpu_torch.serve import generate as gen

    published = ModelConfig.from_hf_dict(DEEPSEEK_V2_LITE)
    cfg = dataclasses.replace(published,
                              num_hidden_layers=V2_LITE_QUANT_LAYERS)
    layers = cfg.num_hidden_layers
    cut = (f"{layers} of {published.num_hidden_layers} layers (1 dense, "
           f"{layers - 1} MoE), published width; calibration "
           f"{V2_LITE_CALIB[0]} x {V2_LITE_CALIB[1]} of {QUANT_CALIB[0]} x "
           f"{QUANT_CALIB[1]}")
    qcfg = AwqConfig(q_group_size=MLA_MOE_GS, zero_point=True)
    calib = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                              V2_LITE_CALIB)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    fp = synth_float_on_card(cfg, 0, dev)
    torch.cuda.synchronize()
    emit({"phase": "quantize", "step": "synth", "model": "deepseek-v2-lite",
          "layers": layers, "depth_cut": cut,
          "seconds": time.perf_counter() - t})

    torch.cuda.reset_peak_memory_stats()
    model = AwqCausalLM(cfg, fp, device=dev)
    t = time.perf_counter()
    model.quantize(calib_data=calib, quant_config=qcfg,
                   max_calib_samples=V2_LITE_CALIB[0],
                   max_calib_seq_len=V2_LITE_CALIB[1], progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    q = model._quantizer
    dense_mem = all("dense" in lp["self_attn"]["kv_b_proj"]
                    for lp in model.params["layers"])
    router_float = "kernel" in model.params["layers"][1]["mlp"]["gate"]
    emit({"phase": "quantize", "step": "quantize",
          "model": "deepseek-v2-lite", "layers": layers, "depth_cut": cut,
          "card": card(), "calib": list(V2_LITE_CALIB),
          "recipe": f"g{MLA_MOE_GS}, zero point, scale and clip search, f32",
          "seconds": seconds, "seconds_by_part": _quant_timings(q, seconds),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "scale_groups": [len(c) for c in q.scale_choices],
          "layer0_ratio_index": _ratio_indices(q),
          "dense_leaf_in_memory": dense_mem, "router_float": router_float})
    check(dense_mem, "quantize: V2-Lite's kv_b has no dense leaf after "
          "quantize()")
    check(router_float, "quantize: V2-Lite's router was quantized")
    _quality("deepseek-v2-lite", cfg, fp, model.params, qcfg, dev)
    del fp

    path = os.path.join(BUILD_DIR, "quant_v2_lite")
    shutil.rmtree(path, ignore_errors=True)
    try:
        t = time.perf_counter()
        model.save_quantized(path)
        t_save = time.perf_counter() - t
        dense_saved = any("dense" in k for k in _saved_keys(path))
        # loaded once, unfused in the checkpoint's dtypes, held exactly,
        # then cast and fused to serve
        t = time.perf_counter()
        loaded = AwqCausalLM.from_quantized(path, device=dev, dtype=None)
        t_load = time.perf_counter() - t
    finally:
        shutil.rmtree(path, ignore_errors=True)
    mismatched = _reload_mismatches(model.params, loaded.params)
    dense_loaded = all("dense" in lp["self_attn"]["kv_b_proj"]
                       for lp in loaded.params["layers"])
    params = fuse_model(cfg, cast_params(loaded.params, torch.bfloat16))
    del loaded
    check(not mismatched, f"quantize: V2-Lite's reloaded tensors differ at "
          f"{mismatched[:4]}")
    check(dense_loaded and not dense_saved, "quantize: V2-Lite's dense "
          f"leaf: reloaded {dense_loaded}, written {dense_saved}")
    emit({"phase": "quantize", "step": "save_load",
          "model": "deepseek-v2-lite", "save_s": t_save, "load_s": t_load,
          "reload_mismatches": len(mismatched),
          "dense_leaf_reloaded": dense_loaded,
          "dense_leaf_written": dense_saved})
    del model, q

    rng = np.random.default_rng(21)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, 64))).to(dev)
    caches = gen.init_kv_cache(cfg, 1, 80, torch.bfloat16, dev)
    logits, _ = gen.prefill(cfg, params, prompt, caches)
    _build.reset_launches()
    gen.decode_step(cfg, params, logits.argmax(-1)[:, None], caches, 64)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    del caches
    _check_launches("V2-Lite quantized decode step", counts,
                    {"w4a16_gemv": 3 * layers, "fused_mlp": 1,
                     "moe_gemm": 2 * (layers - 1),
                     "fused_mlp3": layers - 1, "fused_attn_step": 0,
                     "w4a16_gemm": 0})
    rows, routing = _checked_teacher_forced("V2-Lite quantized", cfg,
                                            params, prompt, 16)
    emit({"phase": "quantize", "step": "serve", "model": "deepseek-v2-lite",
          "card": card(), "launches_per_decode_step": counts,
          "kernel_vs_plain": rows, "routing": routing})
    del params
    torch.cuda.empty_cache()
    return counts


def synth_float_on_card(cfg, seed, dev, scale=0.05):
    """Seeded f32 float weights of a decoder-zoo model, drawn on the card
    by a torch.Generator (std ``scale`` and norms of ones, as
    ``io/hf.init_random_params``) in the layout ``io/hf`` loads its
    checkpoint into: a fused ``qkv_proj`` where the checkpoint stores one
    (MPT), q / k / v otherwise (GPT-J); fc1 / fc2 or gate / up / down;
    zero biases where the config has them; LayerNorms with a zero bias,
    except MPT's. MLA models get MLA's projections and norms; MoE layers
    (from ``first_k_dense_replace`` on) a float router (for ``noaux_tc``
    with an ``e_score_correction_bias``), a list of float experts and,
    where the config has them, deepseek's shared experts, the layout the
    quantizer calibrates. Embedding columns 0-5 are multiplied by 8, as in
    ``_outlier_fp``. JAX's ``init_random_params`` draws llama shapes only,
    and a numpy draw on the host takes minutes at these widths."""
    import torch

    from autoawq_tpu_torch.io.hf import get_layout

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    hd, nh, nkv = (cfg.head_dim_, cfg.num_attention_heads,
                   cfg.num_key_value_heads)

    def norm(n=h):
        p = {"weight": torch.ones(n, device=dev)}
        if cfg.norm_kind == "ln" and cfg.model_type != "mpt":
            p["bias"] = torch.zeros(n, device=dev)
        return p

    def lin(k, n, bias=False):
        p = {"kernel": torch.randn(k, n, device=dev, generator=gen) * scale}
        if bias:
            p["bias"] = torch.zeros(n, device=dev)
        return p

    emb = torch.randn(cfg.vocab_size, h, device=dev, generator=gen) * scale
    emb[:, :6] *= 8.0
    params = {"embed_tokens": {"weight": emb}, "norm": norm(),
              "lm_head": None if cfg.tie_word_embeddings else lin(
                  h, cfg.vocab_size, cfg.lm_head_bias), "layers": []}
    def gated(n, bias=False):
        return {"gate_proj": lin(h, n, bias), "up_proj": lin(h, n, bias),
                "down_proj": lin(n, h, bias)}

    def mla():
        dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        attn = {"kv_a_proj_with_mqa": lin(
                    h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                "kv_a_layernorm": norm(cfg.kv_lora_rank),
                "kv_b_proj": lin(cfg.kv_lora_rank, nh * (
                    cfg.qk_nope_head_dim + cfg.v_head_dim)),
                "o_proj": lin(nh * cfg.v_head_dim, h)}
        if cfg.q_lora_rank:
            attn.update(q_a_proj=lin(h, cfg.q_lora_rank),
                        q_a_layernorm=norm(cfg.q_lora_rank),
                        q_b_proj=lin(cfg.q_lora_rank, nh * dq))
        else:
            attn["q_proj"] = lin(h, nh * dq)
        return attn

    def moe():
        ie, ne = cfg.moe_intermediate_size or inter, cfg.num_experts
        m = {"gate": lin(h, ne), "experts": [gated(ie) for _ in range(ne)]}
        if cfg.topk_method == "noaux_tc":
            m["gate"]["e_score_correction_bias"] = torch.randn(
                ne, device=dev, generator=gen) * scale
        if cfg.n_shared_experts:
            m["shared_experts"] = gated(ie * cfg.n_shared_experts)
        return m

    fused = "self_attn.qkv_proj" in get_layout(cfg.model_type).linears
    for i in range(cfg.num_hidden_layers):
        if cfg.is_mla:
            attn = mla()
        elif fused:
            attn = {"qkv_proj": lin(h, (nh + 2 * nkv) * hd,
                                    cfg.attention_bias)}
        else:
            attn = {f"{n}_proj": lin(h, heads * hd, cfg.attention_bias)
                    for n, heads in (("q", nh), ("k", nkv), ("v", nkv))}
        if not cfg.is_mla:
            attn["o_proj"] = lin(nh * hd, h)
        lp = {"input_layernorm": norm(), "self_attn": attn}
        if not (cfg.parallel_residual and cfg.shared_input_norm):
            lp["post_attention_layernorm"] = norm()
        if cfg.is_moe and i >= cfg.first_k_dense_replace:
            lp["mlp"] = moe()
        elif cfg.gated_mlp:
            lp["mlp"] = gated(inter, cfg.mlp_bias)
        else:
            lp["mlp"] = {"fc1": lin(h, inter, cfg.mlp_bias),
                         "fc2": lin(inter, h, cfg.mlp_bias)}
        params["layers"].append(lp)
    return params


def _zoo_model(hf_dict, dev, depth=None, phase="zoo", gs=128, **cut):
    """ModelConfig of a published config (depth cut to ``depth`` layers
    where given, and other fields replaced by ``cut``, printed) and its
    weights on the card at group size ``gs``."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import attach_kv_b_dense
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig.from_hf_dict(hf_dict)
    full = cfg.num_hidden_layers
    published = {k: getattr(cfg, k) for k in cut}
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=depth)
    cfg = dataclasses.replace(cfg, **cut)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = attach_kv_b_dense(cfg, synth_zoo_params(cfg, 0, dev, gs))
    torch.cuda.synchronize()
    emit({"phase": phase, "model": cfg.model_type, "step": "synth",
          "layers": cfg.num_hidden_layers, "published_layers": full,
          "cut": None if depth is None else
          f"depth {depth} of {full} layers, published width",
          "fields_cut": {k: {"published": published[k], "run": cut[k]}
                         for k in cut},
          "group_size": gs, "seconds": time.perf_counter() - t0,
          "allocated_bytes": torch.cuda.memory_allocated()})
    torch.cuda.reset_peak_memory_stats()
    return cfg, params


def _timed_prefill(cfg, params, prompt, cap, runs=2):
    """Seconds of ``runs`` prefills (after a warm-up), the launches of one,
    and a device profile of two."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen

    caches = gen.init_kv_cache(cfg, prompt.shape[0], cap, torch.bfloat16,
                               prompt.device)
    gen.prefill(cfg, params, prompt, caches)
    torch.cuda.synchronize()
    _build.reset_launches()
    gen.prefill(cfg, params, prompt, caches)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        gen.prefill(cfg, params, prompt, caches)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    prof = device_profile(lambda i: gen.prefill(cfg, params, prompt, caches),
                          2)
    del caches
    return times, launches, prof


def _check_launches(name, got, expect):
    for kernel, n in expect.items():
        check(got.get(kernel, 0) == n,
              f"traffic {name}: {got.get(kernel, 0)} {kernel} launches, "
              f"expected {n}")


def _mpt_traffics(dev, gen_t, rng):
    """MPT-7B at full width and depth: kernel rows at its shapes, traffics
    L (bs1 decode), M (prefill 2 x 384) and N (the paged engine), each with
    its launches held exactly and its teacher-forced check. Returns the
    launch counts of L, M and N and L's and N's launches per decode
    step."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen

    cfg, params = _zoo_model(MPT7B, dev)
    layers, h = cfg.num_hidden_layers, cfg.hidden_size
    heads = {"num_attention_heads": cfg.num_attention_heads,
             "num_key_value_heads": cfg.num_key_value_heads,
             "head_dim": cfg.head_dim_}
    for case, k, n in (("MPT-7B qkv", h, 3 * h), ("MPT-7B out_proj", h, h),
                       ("MPT-7B fc1", h, cfg.intermediate_size),
                       ("MPT-7B fc2", cfg.intermediate_size, h)):
        _gemm_case(rng, "w4a16_gemv", case, 1, k, n, 128, True, dev)
    _gemm_case(rng, "w4a16_gemm", "MPT-7B fc1 M", 768, h,
               cfg.intermediate_size, 128, True, dev, iters=20)
    _paged_case(gen_t, "paged_attn", "MPT-7B N alibi", heads, dev,
                alibi=True)
    counts, per_step = {}, {}

    prompt_l = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, 64))).to(dev)

    def run_l(n):
        t = time.perf_counter()
        out = gen.generate(cfg, params, prompt_l, n).cpu()
        return time.perf_counter() - t, out

    t0 = time.perf_counter()
    _build.reset_launches()
    tok_s, t_small, t_big, per_step["L"], out = _quotient(
        run_l, 32, DECODE_BIG, 2, warm=(32,))
    counts["L"] = dict(_build.LAUNCHES)
    check(out.shape == (1, 64 + DECODE_BIG)
          and bool((out < cfg.vocab_size).all()), "traffic L output")
    _check_launches("L (a decode step)", per_step["L"],
                    {"w4a16_gemv": 4 * layers, "fused_mlp": 0,
                     "fused_attn_step": 0, "paged_attn": 0})
    emit({"phase": "zoo", "traffic": "L", "model": "mpt-7b", "card": card(),
          "batch": 1, "prompt": 64,
          "method": f"A's: {DECODE_BIG}- and 32-token quotient, min of 2",
          "decode_tok_s": tok_s, "t_32_s": t_small,
          f"t_{DECODE_BIG}_s": t_big,
          "launches": counts["L"], "launches_per_decode_step": per_step["L"],
          "seconds": time.perf_counter() - t0})
    emit({"phase": "zoo", "step": "profile", "traffic": "L", "card": card(),
          "what": "decode_step", **profile_decode(cfg, params, prompt_l, 16)})
    rows = _teacher_forced(cfg, params, prompt_l, 8)
    _check_teacher_forced("L", rows)
    emit({"phase": "zoo", "step": "kernel_vs_plain", "traffic": "L",
          "layers": layers, "rows": rows})

    prompt_m = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (2, 384))).to(dev)
    times, counts["M"], prof = _timed_prefill(cfg, params, prompt_m, 416)
    _check_launches("M (a prefill)", counts["M"],
                    {"w4a16_gemm": 4 * layers, "prefill_attention": 0,
                     "w4a16_gemv": 0})
    emit({"phase": "zoo", "traffic": "M", "model": "mpt-7b", "card": card(),
          "batch": 2, "prompt": 384, "prefill_s": min(times),
          "prefill_runs_s": times, "prefill_tok_s": 768 / min(times),
          "launches": counts["M"]})
    emit({"phase": "zoo", "step": "profile", "traffic": "M", "card": card(),
          "what": "prefill", **prof})
    rows = _teacher_forced(cfg, params, prompt_m, 1)
    _check_teacher_forced("M", rows)
    emit({"phase": "zoo", "step": "kernel_vs_plain", "traffic": "M",
          "layers": layers, "rows": rows})

    prompts = [rng.integers(0, cfg.vocab_size, (64,)) for _ in range(16)]
    t0 = time.perf_counter()
    counts["N"], per_step["N"] = _paged_traffic(
        cfg, params, "N", prompts, 3,
        {"paged_attn": layers, "paged_attn_stock": 0,
         "w4a16_gemv": 4 * layers, "fused_mlp": 0, "fused_attn_step": 0},
        True)
    rows = _teacher_forced_paged(cfg, params, prompts, 3)
    _check_teacher_forced("N", rows)
    emit({"phase": "zoo", "step": "kernel_vs_plain", "traffic": "N",
          "layers": layers, "rows": rows,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "zoo", "model": "mpt-7b", "card": card(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    del params
    return counts, per_step


def _zoo_family(name, hf_dict, dev, rng, expect_decode, expect_prefill,
                expect_paged):
    """One family at published width, depth ``ZOO_DEPTH``, through
    ``_served_checks``. Returns its launch counts."""
    cfg, params = _zoo_model(hf_dict, dev, ZOO_DEPTH)
    counts = _served_checks("zoo", name, cfg, params, dev, rng,
                            expect_decode, expect_prefill, expect_paged)
    del params
    return counts


def _checked_teacher_forced(name, cfg, params, prompt, steps,
                            kv_quant=False):
    """``_teacher_forced`` (``_teacher_forced_moe`` for an MoE model, with
    its routing held too), checked. Returns (rows, routing summary or
    None)."""
    if not cfg.is_moe:
        rows = _teacher_forced(cfg, params, prompt, steps, kv_quant)
        _check_teacher_forced(name, rows)
        return rows, None
    rows, routing, _ = _teacher_forced_moe(cfg, params, prompt, steps,
                                           kv_quant)
    _check_teacher_forced(name, rows)
    _check_routing(name, routing)
    return rows, routing


def _served_checks(phase, name, cfg, params, dev, rng, expect_decode,
                   expect_prefill, expect_paged):
    """One prefill of 2 x 384, 16 teacher-forced decode steps at bs1 and
    one paged step at bs8, each held with its launches and its
    teacher-forced check. Returns the launch counts of the three, summed."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen

    counts = {}
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (2, 384))).to(dev)
    times, counts["prefill"], prof = _timed_prefill(cfg, params, prompt,
                                                    416, runs=1)
    _check_launches(f"{name} prefill", counts["prefill"], expect_prefill)
    rows, routing = _checked_teacher_forced(f"{name} prefill", cfg, params,
                                            prompt, 1)
    emit({"phase": phase, "model": name, "what": "prefill 2 x 384",
          "card": card(), "prefill_s": min(times),
          "device_ms": prof["device_ms_per_call"],
          "launches": counts["prefill"], "kernel_vs_plain": rows,
          "routing": routing})

    prompt1 = prompt[:1, :64].contiguous()
    rows, routing = _checked_teacher_forced(f"{name} decode", cfg, params,
                                            prompt1, 16)
    caches = gen.init_kv_cache(cfg, 1, 80, torch.bfloat16, dev)
    logits, _ = gen.prefill(cfg, params, prompt1, caches)
    _build.reset_launches()
    gen.decode_step(cfg, params, logits.argmax(-1)[:, None], caches, 64)
    torch.cuda.synchronize()
    counts["decode"] = dict(_build.LAUNCHES)
    del caches
    _check_launches(f"{name} decode step", counts["decode"], expect_decode)
    emit({"phase": phase, "model": name, "what": "bs1 decode, 16 steps "
          "teacher-forced", "card": card(), "launches_per_decode_step":
          counts["decode"], "kernel_vs_plain": rows, "routing": routing})

    prompts = [rng.integers(0, cfg.vocab_size, (64,)) for _ in range(8)]
    busy = _busy_engine(cfg, params, prompts)
    _build.reset_launches()
    busy.step()
    torch.cuda.synchronize()
    counts["paged"] = dict(_build.LAUNCHES)
    del busy
    _check_launches(f"{name} paged step", counts["paged"], expect_paged)
    rows = _teacher_forced_paged(cfg, params, prompts, 1)
    _check_teacher_forced(f"{name} paged", rows)
    emit({"phase": phase, "model": name, "what": "paged step, 8 slots",
          "card": card(), "launches_per_step": counts["paged"],
          "kernel_vs_plain": rows})
    return {k: sum(c.get(k, 0) for c in counts.values())
            for k in counts["paged"]}


def phase_zoo(dev):
    """The decoder zoo on the card: MPT-7B's traffics L, M and N at full
    width and depth, then Gemma-2-9B, Qwen3-8B and GPT-J-6B at published
    width, depth ``ZOO_DEPTH``, with kernel rows at their new shapes.
    Returns (launch counts summed over the phase, launches per decode step
    of L and N)."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig

    rng = np.random.default_rng(10)
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(10)
    counts, per_step = _mpt_traffics(dev, gen_t, rng)

    g = ModelConfig.from_hf_dict(GEMMA2_9B)
    _mlp_case(rng, 1, "gelu_pytorch_tanh", dev, h=g.hidden_size,
              inter=g.intermediate_size, case="Gemma-2-9B")
    _paged_case(gen_t, "paged_attn", "Gemma-2-9B softcap",
                {"num_attention_heads": g.num_attention_heads,
                 "num_key_value_heads": g.num_key_value_heads,
                 "head_dim": g.head_dim_}, dev, softcap=50.0, window=4096)
    _attn_case(2, 384, 32, 8, 128, dev, case="Qwen3-8B prefill")
    _attn_case(2, 384, 16, 16, 256, dev, case="GPT-J-6B prefill")
    d = ZOO_DEPTH
    counts["gemma2"] = _zoo_family(
        "gemma-2-9b", GEMMA2_9B, dev, rng,
        {"w4a16_gemv": 2 * d, "fused_mlp": d, "fused_attn_step": 0},
        {"w4a16_gemm": 4 * d, "prefill_attention": 0},
        {"w4a16_gemv": 2 * d, "fused_mlp": d, "paged_attn": d,
         "paged_attn_stock": 0})
    counts["qwen3"] = _zoo_family(
        "qwen3-8b", QWEN3_8B, dev, rng,
        {"w4a16_gemv": 2 * d, "fused_mlp": d, "fused_attn_step": 0},
        {"w4a16_gemm": 4 * d, "prefill_attention": d},
        {"w4a16_gemv": 2 * d, "fused_mlp": d, "paged_attn": d,
         "paged_attn_stock": 0})
    counts["gptj"] = _zoo_family(
        "gpt-j-6b", GPTJ_6B, dev, rng,
        {"w4a16_gemv": 4 * d, "fused_mlp": 0, "fused_attn_step": 0},
        {"w4a16_gemm": 4 * d, "prefill_attention": d},
        {"w4a16_gemv": 4 * d, "paged_attn": d, "paged_attn_stock": 0})
    total = {k: sum(c.get(k, 0) for c in counts.values())
             for k in counts["L"]}
    for name in ("w4a16_gemv", "w4a16_gemm", "fused_mlp",
                 "prefill_attention", "paged_attn"):
        check(total.get(name, 0) > 0,
              f"kernel {name} never launched on the zoo's path")
    return total, per_step


def _mla_moe_kernel_rows(dev, rng, gen_t):
    """K6 against its twin at DeepSeek-V2-Lite's decode and prefill shapes
    (64 experts, top-6), at Qwen3-30B-A3B's (128, top-8) and DeepSeek-V3's
    (256, top-8; its down_proj's widths), K8 at V2-Lite's shared experts,
    and, at V2-Lite's g64, K1 at O's and R's decode linears, K2 at P's
    prefill linears and K3 at the dense layer 0. Returns the timed rows for
    the ``kernels`` line."""
    import torch

    from autoawq_tpu_torch.utils.synth import synth_qlin

    v2 = DEEPSEEK_V2_LITE
    h, ie, ne, k = (v2["hidden_size"], v2["moe_intermediate_size"],
                    v2["n_routed_experts"], v2["num_experts_per_tok"])
    rows = []
    gu = synth_qlin(gen_t, h, 2 * ie, MLA_MOE_GS, experts=ne)
    dn = synth_qlin(gen_t, ie, h, MLA_MOE_GS, experts=ne)
    rows.append(_moe_case(gen_t, "V2-Lite O decode, gate_up (6 of 64)", gu,
                          1, dev, k=k))
    _moe_case(gen_t, "V2-Lite O decode, down (6 of 64)", dn, 1, dev, k=k,
              yardsticks=False)
    _moe_case(gen_t, "V2-Lite R decode, gate_up (8 slots)", gu, 8, dev,
              k=k, yardsticks=False)
    rows.append(_moe_case(gen_t, "V2-Lite P prefill, gate_up (bm 16)", gu,
                          768, dev, iters=10, k=k))
    rows.append(_moe_case(gen_t, "V2-Lite P prefill, down (bm 16)", dn, 768,
                          dev, iters=10, k=k))
    del gu, dn
    q = QWEN3_30B_A3B
    gu = synth_qlin(gen_t, q["hidden_size"], 2 * q["moe_intermediate_size"],
                    experts=q["num_experts"])
    for t in (1, 768):
        _moe_case(gen_t, f"Qwen3-30B-A3B gate_up T={t} (8 of 128)", gu, t,
                  dev, timing=False, k=8)
    del gu
    v3 = DEEPSEEK_V3
    dn = synth_qlin(gen_t, v3["moe_intermediate_size"], v3["hidden_size"],
                    experts=v3["n_routed_experts"])
    for t in (1, 768):
        _moe_case(gen_t, f"DeepSeek-V3 down T={t} (8 of 256)", dn, t, dev,
                  timing=False, k=8)
    del dn
    torch.cuda.empty_cache()
    si = ie * v2["n_shared_experts"]
    rows.append(_mlp3_case(rng, "V2-Lite shared experts M=1", 1, h, si,
                           "silu", dev, gs=MLA_MOE_GS))
    _mlp3_case(rng, "V2-Lite shared experts M=8", 8, h, si, "silu", dev,
               timing=False, gs=MLA_MOE_GS)
    # V2-Lite's linears as its traffics call them, at g64: K1 at O's and
    # R's decode (M = 1, 8; kv_a's 576 is no multiple of 128), K2 at P's
    # prefill (M = 768; also kv_b, the shared experts and the dense layer
    # 0's 10,944, 171 groups of 64), K3 at the dense layer 0's decode
    nh, dn = v2["num_attention_heads"], v2["qk_nope_head_dim"]
    dense = v2["intermediate_size"]
    decode = {"q_proj": (h, nh * (dn + v2["qk_rope_head_dim"])),
              "kv_a_proj_with_mqa": (h, v2["kv_lora_rank"]
                                     + v2["qk_rope_head_dim"]),
              "o_proj": (nh * v2["v_head_dim"], h)}
    prefill = {**decode,
               "kv_b_proj": (v2["kv_lora_rank"], nh * (dn + v2["v_head_dim"])),
               "shared gate / up": (h, si), "shared down": (si, h),
               "dense gate_up": (h, 2 * dense), "dense down": (dense, h)}
    for name, (kk, n) in decode.items():
        for m in (1, 8):
            _gemm_case(rng, "w4a16_gemv", f"V2-Lite {name}", m, kk, n,
                       MLA_MOE_GS, True, dev, timing=False, gen=gen_t)
    for name, (kk, n) in prefill.items():
        _gemm_case(rng, "w4a16_gemm", f"V2-Lite P {name}", 768, kk, n,
                   MLA_MOE_GS, True, dev, timing=False, gen=gen_t)
    for m in (1, 8):
        _mlp_case(rng, m, "silu", dev, timing=False, h=h, inter=dense,
                  case="V2-Lite dense layer 0", gs=MLA_MOE_GS, gen=gen_t)
    return rows


def _decode_step_bytes(cfg, params, experts_read):
    """Bytes one bs1 decode step must read, and what the port reads beyond
    them: every linear's packed weights (kv_b's too), the router,
    ``experts_read`` routed experts of each MoE layer, the shared experts,
    the head and one embedding row; beyond them, kv_b's f32 dense weight,
    which the port's absorbed MLA decode reads in place of the packed one
    (``nn/fuse.attach_kv_b_dense``), less that packed weight."""
    def nbytes(node):
        if isinstance(node, dict):
            return sum(nbytes(v) for k, v in node.items() if k != "dense")
        return node.numel() * node.element_size() if node is not None else 0

    total = nbytes(params["lm_head"]) + nbytes(params["norm"])
    total += params["embed_tokens"]["weight"][0].numel() * 2
    extra = 0
    for lp in params["layers"]:
        total += nbytes(lp["self_attn"])
        kv_b = lp["self_attn"].get("kv_b_proj")
        if kv_b is not None and "dense" in kv_b:
            extra += kv_b["dense"].numel() * 4 - nbytes(kv_b)
        m = dict(lp["mlp"])
        st = m.pop("experts_stacked", None)
        total += nbytes(m)
        if st is not None:
            total += nbytes(st) * experts_read // cfg.num_experts
    return total, extra


def _v2_lite_traffics(dev, rng):
    """DeepSeek-V2-Lite at full width, ``V2_LITE_DEPTH`` layers: traffics O
    (bs1 decode),
    P (prefill 2 x 384) and R (the paged engine on a latent pool), each
    with its launches held exactly and its teacher-forced check, the int8
    latent cache, the paged step against the contiguous latent path, and
    the MoE block held per layer. Returns the launch counts of O, P and R
    and O's and R's launches per decode step."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen

    cfg, params = _zoo_model(DEEPSEEK_V2_LITE, dev, V2_LITE_DEPTH,
                             phase="mla_moe", gs=MLA_MOE_GS)
    layers = cfg.num_hidden_layers
    moe = layers - cfg.first_k_dense_replace
    dense = cfg.first_k_dense_replace
    latent = gen.init_kv_cache(cfg, 1, 64, device=dev)
    full = gen.init_kv_cache(cfg, 1, 64, device=dev, mla_latent=False)

    def per_token(caches):
        return sum(t.numel() * t.element_size() for c in caches
                   for t in c.values()) / 64
    emit({"phase": "mla_moe", "model": "deepseek-v2-lite", "card": card(),
          "group_size": MLA_MOE_GS, "why_g64": "10944 = 85.5 x 128",
          "latent_cache_bytes_per_token": per_token(latent),
          "materialized_kv_bytes_per_token": per_token(full),
          "ratio": per_token(full) / per_token(latent)})
    del latent, full
    counts, per_step = {}, {}
    expect_o = {"w4a16_gemv": 3 * layers, "moe_gemm": 2 * moe,
                "fused_mlp3": moe, "fused_mlp": dense, "fused_attn_step": 0,
                "paged_attn": 0, "w4a16_gemm": 0}

    prompt_o = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, 64))).to(dev)

    def run_o(n):
        t = time.perf_counter()
        out = gen.generate(cfg, params, prompt_o, n).cpu()
        return time.perf_counter() - t, out

    t0 = time.perf_counter()
    _build.reset_launches()
    # one run each (min of 2 until the parallel phase came, for time)
    tok_s, t_small, t_big, per_step["O"], out = _quotient(run_o, 16, 64, 1,
                                                          warm=(16,))
    counts["O"] = dict(_build.LAUNCHES)
    check(out.shape == (1, 64 + 64) and bool((out < cfg.vocab_size).all()),
          "traffic O output")
    _check_launches("O (a decode step)", per_step["O"], expect_o)
    prof = profile_decode(cfg, params, prompt_o, 16)
    step_bytes, dense_extra = _decode_step_bytes(cfg, params,
                                                 cfg.num_experts_per_tok)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "mla_moe", "traffic": "O", "model": "deepseek-v2-lite",
          "card": card(), "batch": 1, "prompt": 64,
          "method": "64- and 16-token quotient, min of 2",
          "decode_tok_s": tok_s, "t_16_s": t_small, "t_64_s": t_big,
          "device_ms_per_step": prof["device_ms_per_call"],
          "device_busy_share": prof["device_busy_share"],
          "step_bytes": step_bytes, "step_bound_ms": bound_ms,
          "kv_b_dense_extra_bytes": dense_extra,
          "kv_b_dense_extra_ms": dense_extra / HBM_BYTES_PER_S * 1e3,
          "device_ms_over_bound": prof["device_ms_per_call"] / bound_ms,
          "launches": counts["O"], "launches_per_decode_step": per_step["O"],
          "seconds": time.perf_counter() - t0})
    emit({"phase": "mla_moe", "step": "profile", "traffic": "O",
          "card": card(), "what": "decode_step", **prof})
    for kv_quant in (False, True):
        name = "O int8 latent" if kv_quant else "O"
        rows, routing, taps = _teacher_forced_moe(cfg, params, prompt_o, 4,
                                                  kv_quant)
        _check_teacher_forced(name, rows)
        _check_routing(name, routing)
        emit({"phase": "mla_moe", "step": "kernel_vs_plain",
              "traffic": name, "cache": "int8" if kv_quant else "bf16",
              "routing": routing, "rows": rows})
        if not kv_quant:
            emit({"phase": "mla_moe", "step": "moe_block_per_layer",
                  "traffic": name, "card": card(),
                  "limit": TOL["moe_block"],
                  "rows": _moe_layer_check(cfg, params, name, taps)})
        del taps

    prompt_p = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (2, 384))).to(dev)
    times, counts["P"], prof = _timed_prefill(cfg, params, prompt_p, 416)
    _check_launches("P (a prefill)", counts["P"], {
        "w4a16_gemm": 4 * layers + 2 * dense + 3 * moe, "moe_gemm": 2 * moe,
        "prefill_attention": 0, "w4a16_gemv": 0, "fused_mlp3": 0})
    emit({"phase": "mla_moe", "traffic": "P", "model": "deepseek-v2-lite",
          "card": card(), "batch": 2, "prompt": 384, "prefill_s": min(times),
          "prefill_runs_s": times, "prefill_tok_s": 768 / min(times),
          "device_ms": prof["device_ms_per_call"], "launches": counts["P"]})
    emit({"phase": "mla_moe", "step": "profile", "traffic": "P",
          "card": card(), "what": "prefill", **prof})
    rows, routing, _ = _teacher_forced_moe(cfg, params, prompt_p, 0)
    _check_teacher_forced("P", rows)
    _check_routing("P", routing)
    emit({"phase": "mla_moe", "step": "kernel_vs_plain", "traffic": "P",
          "routing": routing, "rows": rows})

    prompts = [rng.integers(0, cfg.vocab_size, (64,)) for _ in range(16)]
    t0 = time.perf_counter()
    counts["R"], per_step["R"] = _paged_traffic(
        cfg, params, "R", prompts, 2, {**expect_o, "paged_attn_stock": 0},
        False)
    rows = _teacher_forced_paged(cfg, params, prompts, 2)
    _check_teacher_forced("R", rows)
    rows8 = _teacher_forced_paged(cfg, params, prompts, 1, kv_quant=True)
    _check_teacher_forced("R int8 pool", rows8)
    versus = _paged_vs_contiguous(cfg, params, prompts)
    limit = 2 * rows[0]["plain_bf16_vs_f32"] + 1e-3
    check(versus <= limit, f"traffic R: the paged latent step is {versus:.4g}"
          f" from the contiguous latent path, limit {limit:.4g}")
    emit({"phase": "mla_moe", "step": "kernel_vs_plain", "traffic": "R",
          "layers": layers, "rows": rows, "int8_pool_rows": rows8,
          "paged_vs_contiguous": versus, "paged_vs_contiguous_limit": limit,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "mla_moe", "model": "deepseek-v2-lite", "card": card(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    del params
    return counts, per_step


def phase_mla_moe(dev):
    """MLA and DeepSeek / Qwen3 MoE on the card: kernel rows at their
    shapes, DeepSeek-V2-Lite's traffics O, P and R at full width,
    ``V2_LITE_DEPTH`` layers (``_v2_lite_traffics``), then DeepSeek-V3 and
    Qwen3-30B-A3B at published width, depth ``MLA_MOE_CUT_DEPTH``, through
    ``_served_checks``. Returns (launch counts summed over the phase,
    launches per decode step of O and R, the kernel rows)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(12)
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(12)
    krows = _mla_moe_kernel_rows(dev, rng, gen_t)
    counts, per_step = _v2_lite_traffics(dev, rng)
    d = MLA_MOE_CUT_DEPTH
    cfg, params = _zoo_model(DEEPSEEK_V3, dev, d, phase="mla_moe",
                             first_k_dense_replace=1)
    # 1 dense + 1 MoE layer: q_a, q_b, kv_a, o on K1 at decode (kv_b in the
    # absorbed decode), and kv_b on K2 at prefill; K3 the dense MLP, K8 the
    # shared expert
    counts["v3"] = _served_checks(
        "mla_moe", "deepseek-v3", cfg, params, dev, rng,
        {"w4a16_gemv": 4 * d, "fused_mlp": 1, "moe_gemm": 2,
         "fused_mlp3": 1, "fused_attn_step": 0},
        {"w4a16_gemm": 5 * d + 2 + 3, "moe_gemm": 2,
         "prefill_attention": 0},
        {"w4a16_gemv": 4 * d, "fused_mlp": 1, "moe_gemm": 2,
         "fused_mlp3": 1, "paged_attn": 0, "paged_attn_stock": 0})
    del params
    cfg, params = _zoo_model(QWEN3_30B_A3B, dev, d, phase="mla_moe")
    counts["qwen3_moe"] = _served_checks(
        "mla_moe", "qwen3-30b-a3b", cfg, params, dev, rng,
        {"w4a16_gemv": 2 * d, "moe_gemm": 2 * d, "fused_mlp": 0,
         "fused_attn_step": 0},
        {"w4a16_gemm": 2 * d, "moe_gemm": 2 * d, "prefill_attention": d},
        {"w4a16_gemv": 2 * d, "moe_gemm": 2 * d, "paged_attn": d,
         "paged_attn_stock": 0})
    del params
    torch.cuda.empty_cache()
    total = {k: sum(c.get(k, 0) for c in counts.values())
             for k in counts["O"]}
    for name in ("w4a16_gemv", "w4a16_gemm", "fused_mlp", "moe_gemm",
                 "fused_mlp3", "prefill_attention", "paged_attn"):
        check(total.get(name, 0) > 0,
              f"kernel {name} never launched on the mla_moe phase's path")
    return total, per_step, krows


@contextlib.contextmanager
def _recorded(module, attr, note=None):
    """Within the block ``module.attr`` is wrapped: each call appends (its
    positional arguments, its result, ``note()`` taken before the call) to
    the list the block receives. Results are kept, not copied: each
    recorded function returns fresh logits."""
    fn, log = getattr(module, attr), []

    def wrapper(*a, **kw):
        seen = note() if note else None
        out = fn(*a, **kw)
        log.append((a, out, seen))
        return out
    setattr(module, attr, wrapper)
    try:
        yield log
    finally:
        setattr(module, attr, fn)


def _float_twin(params):
    """``params`` with every quantized linear dequantized once to an f32
    ``kernel``: the values ``awq_matmul_plain`` dequantizes on every call
    (Mistral's linears have no padded rows or columns), so the plain path
    in f32 on it is the plain f32 twin at the cost of an f32 matmul. Other
    leaves are shared."""
    import torch

    from autoawq_tpu_torch.ops.gemm import dequantize

    def walk(node):
        if isinstance(node, dict):
            if "qweight" in node:
                out = {"kernel": dequantize(node["qweight"], node["scales"],
                                            node.get("qzeros"),
                                            torch.float32)}
                if node.get("bias") is not None:
                    out["bias"] = node["bias"]
                return out
            return {kk: walk(v) for kk, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(params)


def _twins(cfg, params, seqs):
    """The plain twins' whole-sequence forwards over seqs [B, T], bf16 and
    f32: [B, T, V] f32 logits each, row t scoring the token after t."""
    import torch

    from autoawq_tpu_torch.nn import modules

    return (modules.forward(cfg, params, seqs, "plain",
                            torch.bfloat16).float(),
            modules.forward(cfg, params, seqs, "plain",
                            torch.float32).float())


def _rows_vs_twins(name, rows, twins):
    """Rows (b, t, logits [V]) of a path under test, each held against the
    twins' row t of sequence b by the teacher-forced rule (within twice
    the bf16 twin's distance from f32, plus 1e-3, of the f32 row's
    scale). Returns a summary: rows held, the largest errors, and the row
    nearest its limit."""
    import torch

    b16, f32 = twins
    recs = []
    for lo in range(0, len(rows), 256):
        part = rows[lo: lo + 256]
        bi = torch.tensor([r[0] for r in part], device=f32.device)
        ti = torch.tensor([r[1] for r in part], device=f32.device)
        x = torch.stack([r[2] for r in part]).float()
        f, p = f32[bi, ti], b16[bi, ti]
        scale = f.abs().amax(-1).clamp_min(1e-30)
        k_rel = ((x - f).abs().amax(-1) / scale).tolist()
        p_rel = ((p - f).abs().amax(-1) / scale).tolist()
        recs += [{"sequence": r[0], "position": r[1], "kernel_vs_f32": kr,
                  "plain_bf16_vs_f32": pr}
                 for r, kr, pr in zip(part, k_rel, p_rel)]
    check(len(recs) > 0, f"{name}: no rows to hold")
    if not recs:
        return {"rows": 0}
    _check_teacher_forced(name, recs)
    return {"rows": len(recs),
            "max_kernel_vs_f32": max(r["kernel_vs_f32"] for r in recs),
            "max_plain_bf16_vs_f32": max(r["plain_bf16_vs_f32"]
                                         for r in recs),
            "nearest_limit": max(recs, key=lambda r: r["kernel_vs_f32"] / (
                2 * r["plain_bf16_vs_f32"] + 1e-3))}


def _used_rows(seqs, calls):
    """The verify rows an engine used, from its recorded chunks: calls[b]
    lists (position P, chunk tokens, chunk logits [C, V]) for sequence b
    (prompt and generated tokens, ``seqs[b]``); row j lies on the stream
    while the chunk's tokens 0..j are the stream's at P..P+j, and those
    are exactly the rows the engine accepted from (a rejected draft leaves
    the stream). Returns {b: {position: (offset in its chunk, logits
    row)}}."""
    out = {}
    for b, seq in enumerate(seqs):
        rows = out.setdefault(b, {})
        for pos, toks, lg in calls[b]:
            for j, t in enumerate(toks):
                if pos + j + 1 >= len(seq) or seq[pos + j] != t:
                    break
                rows[pos + j] = (j, lg[j])
    return out


def _teacher_forced_chunks(cfg, params, seqs, s, k, cap):
    """The verify pass on the kernel route, teacher-forced over seqs [B, T]
    (prompts of s tokens and their streams): the prompts prefilled, then
    chunks of k + 1 stream tokens from position s (``prefill_chunk`` at
    B = 1, ``batched_chunk_step`` at every slot's offset otherwise), every
    row of every chunk kept. Returns rows (b, position, logits [V])."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve.batching import prefill_chunk
    from autoawq_tpu_torch.serve.spec_batch import batched_chunk_step

    b, t = seqs.shape
    cache = gen.init_kv_cache(cfg, b, cap, torch.bfloat16, seqs.device)
    gen.prefill(cfg, params, seqs[:, :s], cache)
    rows = []
    for lo in range(s, t - 1, k + 1):
        toks = seqs[:, lo: min(lo + k + 1, t - 1)]
        if b == 1:
            lg, _ = prefill_chunk(cfg, params, toks, cache, lo)
        else:
            lg, _ = batched_chunk_step(
                cfg, params, toks, cache,
                torch.full((b,), lo, device=seqs.device))
        rows += [(i, lo + j, lg[i, j]) for i in range(b)
                 for j in range(toks.shape[1])]
    return rows


def _near_ties(name, s, gots, wants, used, steps, twins, first=1):
    """Greedy speculative streams against the plain ones, row by row:
    equal, or parting first at generated token p >= ``first`` (1: the
    prefill's token must agree; 0 where both paths' prefill rows are
    recorded at position s - 1) at a bf16 near tie.
    At the row that chose token p (position s + p - 1, the same prefix on
    both paths) the engine's own verify row e and the plain path's own
    decode-step row d each hold the teacher-forced rule against the f32
    twin's row, each took its own argmax, and each path's margin between
    the two tokens is within |e - d|, which the rule caps at twice its
    allowance. Returns per-stream records."""
    b16, f32 = twins
    recs = []
    for b, (got, want) in enumerate(zip(gots, wants)):
        diff = [j for j, (x, y) in enumerate(zip(got, want)) if x != y]
        check(len(got) == len(want), f"{name} {b}: {len(got)} tokens, "
              f"expected {len(want)}")
        check(not diff or diff[0] >= first, f"{name} {b}: the first "
              "token, from the prefill, differs")
        rec = {"equal": not diff}
        recs.append(rec)
        if not diff or diff[0] < first:
            continue
        p = diff[0]
        t, g, w = s + p - 1, got[p], want[p]
        e, d = used[b].get(t, (0, None))[1], steps[b].get(t)
        check(e is not None and d is not None, f"{name} {b}: no recorded "
              f"row at position {t}")
        if e is None or d is None:
            continue
        e, d, f = e.float(), d.float(), f32[b, t]
        scale = float(f.abs().max())
        allow = (2 * float((b16[b, t] - f).abs().max()) / scale
                 + 1e-3) * scale
        dist = float((e - d).abs().max())
        rec.update(
            first_difference=p, engine_token=g, plain_token=w,
            engine_margin=float(e[g] - e[w]), plain_margin=float(d[w] - d[g]),
            f32_margin=float(f[w] - f[g]), distance=dist,
            distance_cap=2 * allow,
            engine_vs_f32=float((e - f).abs().max()) / scale,
            plain_step_vs_f32=float((d - f).abs().max()) / scale,
            plain_bf16_vs_f32=(allow / scale - 1e-3) / 2)
        ok = (int(e.argmax()) == g and int(d.argmax()) == w
              and rec["engine_margin"] <= dist
              and rec["plain_margin"] <= dist and dist <= 2 * allow
              and float((e - f).abs().max()) <= allow
              and float((d - f).abs().max()) <= allow)
        check(ok, f"{name} {b}: greedy stream parts from the plain one at "
              f"generated token {p} without a bf16 near tie: {rec}")
    return recs


def _spec_traffic_s(cfg, params, fparams, dev, rng):
    """Traffic S: bs1 speculative decoding on Mistral-7B, a 64-token prompt,
    128 new tokens, k = 4: a self-draft of the first ``SPEC_DRAFT_LAYERS``
    layers, then draft = target (every proposal accepted but at bf16 near
    ties, and the bonus token), both greedy; then the self-draft at
    temperature 0.8, twice with one seed (the two streams equal). Launches
    held exactly from the run's rounds and draft steps. The greedy runs:
    every verify row they used, and every row of the verify chunks
    teacher-forced over the first run's stream, held against the plain
    twins' forward (``_rows_vs_twins``); the streams against the plain
    greedy ``generate`` (``_near_ties``, on the rows both recorded). Then
    the self-draft greedy run in f32 on the plain path (``fparams``, the
    weights dequantized once), 64 tokens, equal to the plain f32
    ``generate``'s. Returns the launch counts."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve import speculative
    from autoawq_tpu_torch.serve.speculative import (generate_speculative,
                                                     self_draft)

    k, n, s = SPEC_K, 128, 64
    lt = cfg.num_hidden_layers
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, s))).to(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _recorded(gen, "decode_step") as log:
        plain = gen.generate(cfg, params, prompt, n)[0, s:].tolist()
    t_plain = time.perf_counter() - t
    steps = {int(a[4]): out[0][0] for a, out, _ in log}
    dcfg, dparams = self_draft(cfg, params, SPEC_DRAFT_LAYERS)
    counts = {}
    # the sampled run repeats its 32 tokens under the same seed (cut from
    # 128 for the time limit when the parallel phase came)
    runs = (("self-draft", dcfg, dparams, 0.0, n),
            ("draft=target", cfg, params, 0.0, n),
            ("sampled", dcfg, dparams, 0.8, 32),
            ("sampled, again", dcfg, dparams, 0.8, 32))
    sampled, greedy = [], {}
    for name, dc, dp, temp, n_run in runs:
        ld = dc.num_hidden_layers
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _recorded(speculative, "prefill_chunk") as log:
            out, stats = generate_speculative(cfg, params, dc, dp, prompt,
                                              n_run, k=k, temperature=temp,
                                              seed=7)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = dict(_build.LAUNCHES)
        r, d = stats["rounds"], stats["draft_steps"]
        # prefills at M = 64 take K1 four times a layer (the MLP as the
        # unfused chain); a verify chunk at M = k + 1 and a draft step take
        # K1 for qkv and o and K3 for the MLP
        expect = {"w4a16_gemv": 4 * (lt + ld) + 2 * lt * r + 2 * ld * d,
                  "fused_mlp": lt * r + ld * d, "fused_attn_step": 0,
                  "w4a16_gemm": 0, "prefill_attention": 0}
        _check_launches(f"S {name}", got, expect)
        for kname, v in got.items():
            counts[kname] = counts.get(kname, 0) + v
        toks = out[0, s:].tolist()
        rec = {"phase": "serve", "traffic": "S", "run": name,
               "card": card(), "draft_layers": ld, "k": k,
               "temperature": temp, "rounds": r, "draft_steps": d,
               "accept_rate": stats["accept_rate"],
               "tokens_per_round": stats["tokens_per_round"],
               "new_tokens": n_run, "tok_s": n_run / secs, "seconds": secs,
               "plain_greedy_tok_s": n / t_plain,
               "launches": got, "launches_per_round": {
                   kname: (v - (4 * (lt + ld) if kname == "w4a16_gemv"
                                else 0)) / r for kname, v in got.items()
                   if v}}
        if temp == 0.0:
            greedy[name] = (toks, [(int(a[4]), a[2][0].tolist(), res[0][0])
                                   for a, res, _ in log])
        else:
            sampled.append(toks)
            check(len(toks) == n_run and all(0 <= x < cfg.vocab_size
                                             for x in toks),
                  "S sampled output")
        if name == "draft=target":  # some rounds took every proposal
            check(d > k * r, f"S draft=target: no round accepted all "
                  f"{k} proposals ({d} draft steps in {r} rounds)")
        emit(rec)
    check(sampled[0][:32] == sampled[1], "S: the sampled stream does not "
          "repeat under its seed")
    # the greedy runs' verify rows against the plain twins, and their
    # streams against the plain one
    twins_of = {}
    for name, (toks, calls) in greedy.items():
        seq = torch.tensor([prompt[0].tolist() + toks], device=dev)
        if tuple(toks) not in twins_of:
            twins_of[tuple(toks)] = _twins(cfg, params, seq)
        twins = twins_of[tuple(toks)]
        used = _used_rows(seq.tolist(), [calls])
        rows = [(0, t, row) for t, (_, row) in sorted(used[0].items())]
        if name == "self-draft":  # every chunk offset, teacher-forced
            rows += _teacher_forced_chunks(cfg, params, seq, s, k,
                                           s + n + k + 1)
        emit({"phase": "serve", "traffic": "S", "run": name,
              "step": "verify rows", "card": card(),
              "used_rows_by_chunk_offset": [
                  sum(1 for j, _ in used[0].values() if j == jj)
                  for jj in range(k + 1)],
              "vs_twins": _rows_vs_twins(f"S {name} verify", rows, twins),
              "vs_plain_greedy": _near_ties(f"S {name}", s, [toks], [plain],
                                            used, [steps], twins)[0]})
    del twins_of, twins
    # greedy speculation is exact in f32
    n32 = 64
    fcfg, fdparams = self_draft(cfg, fparams, SPEC_DRAFT_LAYERS)
    t = time.perf_counter()
    want = gen.generate(cfg, fparams, prompt, n32, method="plain",
                        dtype=torch.float32)[0, s:].tolist()
    t_plain32 = time.perf_counter() - t
    t = time.perf_counter()
    out, stats = generate_speculative(cfg, fparams, fcfg, fdparams, prompt,
                                      n32, k=k, method="plain",
                                      dtype=torch.float32)
    secs = time.perf_counter() - t
    got32 = out[0, s:].tolist()
    diff = [j for j, (x, y) in enumerate(zip(got32, want)) if x != y]
    emit({"phase": "serve", "traffic": "S", "run": "self-draft, f32 plain",
          "card": card(), "new_tokens": n32, "rounds": stats["rounds"],
          "accept_rate": stats["accept_rate"], "seconds": secs,
          "plain_seconds": t_plain32, "equal": got32 == want,
          "first_difference": diff[0] if diff else None})
    check(got32 == want, f"S f32: the speculative stream parts from plain "
          f"generate's at token {diff[0] if diff else len(want)}")
    # the greedy self-draft run again for 4 new tokens (the two prefills
    # and 3 rounds), profiled
    runs_ = []
    prof = device_profile(lambda i: runs_.append(generate_speculative(
        cfg, params, dcfg, dparams, prompt, 4, k=k)[1]["rounds"]), 1)
    emit({"phase": "serve", "step": "profile", "traffic": "S",
          "card": card(), "run": "self-draft, greedy, 4 new tokens",
          "rounds": runs_[0],
          "device_ms_per_round": prof["device_ms_per_call"] / runs_[0],
          "wall_ms_per_round": prof["wall_ms_per_call"] / runs_[0], **prof})
    return counts


def _spec_traffic_t(cfg, params, fparams, dev, rng):
    """Traffic T: the speculative slot pool on Mistral-7B, 8 slots, 16
    requests of 64 seeded tokens, 64 new each, k = 4, the self-draft,
    greedy: steady tok/s over up to 16 rounds with all 8 slots busy and no
    admission (launches held exactly each round: the draft's k + 1 pool
    steps at M = 8, K1 for qkv and o and K3; the verify pass at M = 40,
    the unfused chain on K1), host and device ms a round, the accept rate,
    capacity fallbacks. Every verify row the pool used, and every row of
    ``batched_chunk_step`` teacher-forced over each wave's streams, held
    against the plain twins' forward; every stream against the plain
    ``BatchingEngine``'s on the rows both recorded (``_near_ties``). Then
    the first 8 requests, 32 new tokens each, through both engines in f32
    on the plain path (``fparams``): equal streams. Returns the launch
    counts."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import batching, spec_batch
    from autoawq_tpu_torch.serve.batching import BatchingEngine
    from autoawq_tpu_torch.serve.spec_batch import SpeculativeBatchingEngine
    from autoawq_tpu_torch.serve.speculative import self_draft

    k, lt, ld, s = SPEC_K, cfg.num_hidden_layers, SPEC_DRAFT_LAYERS, 64
    prompts = [rng.integers(0, cfg.vocab_size, (s,)) for _ in range(16)]
    dcfg, dparams = self_draft(cfg, params, ld)
    eng = SpeculativeBatchingEngine(cfg, params, dcfg, dparams, k=k,
                                    max_batch=8, max_seq_len=256, device=dev)
    for i, p in enumerate(prompts):
        eng.add_request(i, p, 64)

    def seen(e):  # each slot's request and position before the call
        return lambda: ([None if r is None else r.id for r in e.slots],
                         e.pos.copy())

    _build.reset_launches()
    t0 = time.perf_counter()
    with _recorded(spec_batch, "batched_chunk_step", seen(eng)) as log:
        eng.step()  # admits the first 8
        per_round = {"w4a16_gemv": 2 * ld * (k + 1) + 4 * lt,
                     "fused_mlp": ld * (k + 1), "fused_attn_step": 0,
                     "w4a16_gemm": 0}
        steady, times, toks = [], [], 0
        for _ in range(16):
            if len(eng.queue) != 8 or any(r is None for r in eng.slots):
                break
            before = dict(_build.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            emitted = eng.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if len(eng.queue) != 8:
                break  # a slot retired and the next request was admitted
            toks += len(emitted)
            steady.append({kk: v - before[kk]
                           for kk, v in _build.LAUNCHES.items()
                           if v - before[kk]})
        for i, got in enumerate(steady):
            _check_launches(f"T round {i}", got, per_round)
        check(len(steady) >= 4, f"T: only {len(steady)} steady rounds")
        prof = device_profile(lambda i: eng.step(), 2)
        out = eng.run()
        torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    ref_eng = BatchingEngine(cfg, params, max_batch=8, max_seq_len=256,
                             device=dev)
    for i, p in enumerate(prompts):
        ref_eng.add_request(i, p, 64)
    t = time.perf_counter()
    with _recorded(batching, "batched_decode_step", seen(ref_eng)) as rlog:
        ref = ref_eng.run()
    t_ref = time.perf_counter() - t
    calls = {i: [] for i in range(16)}
    for a, res, (ids, pos) in log:
        chunk = a[2].tolist()
        for slot, i in enumerate(ids):
            if i is not None:
                calls[i].append((int(pos[slot]), chunk[slot], res[0][slot]))
    steps = {i: {} for i in range(16)}
    for _, res, (ids, pos) in rlog:
        for slot, i in enumerate(ids):
            if i is not None:
                steps[i][int(pos[slot])] = res[0][slot]
    recs, verify = {}, []
    for wave in (range(8), range(8, 16)):  # as admitted, 8 at a time
        seqs = torch.from_numpy(np.stack([np.concatenate(
            [prompts[i], out[i]]) for i in wave])).to(dev)
        twins = _twins(cfg, params, seqs)
        used = _used_rows(seqs.tolist(), [calls[i] for i in wave])
        rows = [(b, t, row) for b in used for t, (_, row) in sorted(
            used[b].items())]
        verify.append({"engine": _rows_vs_twins(
            "T verify", rows, twins), "teacher_forced": _rows_vs_twins(
            "T teacher-forced chunks",
            _teacher_forced_chunks(cfg, params, seqs, s, k, 256), twins)})
        for i, rec in zip(wave, _near_ties(
                "T request", s, [out[i] for i in wave],
                [ref[i] for i in wave], used, [steps[i] for i in wave],
                twins)):
            if not rec["equal"]:
                recs[i] = rec
        del twins, used, rows
    del log, rlog, calls, steps
    # greedy speculation is exact in f32
    fcfg, fdparams = self_draft(cfg, fparams, ld)
    streams = []
    for e in (SpeculativeBatchingEngine(cfg, fparams, fcfg, fdparams, k=k,
                                        max_batch=8, max_seq_len=256,
                                        method="plain", dtype=torch.float32,
                                        device=dev),
              BatchingEngine(cfg, fparams, max_batch=8, max_seq_len=256,
                             method="plain", dtype=torch.float32,
                             device=dev)):
        for i in range(8):
            e.add_request(i, prompts[i], 32)
        streams.append(e.run())
    equal32 = sum(streams[0][i] == streams[1][i] for i in range(8))
    check(equal32 == 8, f"T f32: {8 - equal32} of 8 speculative streams "
          "part from the plain engine's")
    st = steady and sum(times[:len(steady)])
    emit({"phase": "serve", "traffic": "T", "card": card(), "slots": 8,
          "requests": 16, "k": k, "draft_layers": ld,
          "steady_rounds": len(steady),
          "steady_tok_s": toks / st if st else None,
          "host_ms_per_round": [x * 1e3 for x in times[:len(steady)]],
          "device_ms_per_round": prof["device_ms_per_call"],
          "device_busy_share": prof["device_busy_share"],
          "accept_rate": eng.accept_rate,
          "capacity_fallbacks": eng.capacity_fallbacks,
          "whole_run_tok_s": sum(len(v) for v in out.values()) / whole,
          "plain_engine_tok_s": sum(len(v) for v in ref.values()) / t_ref,
          "launches_per_round": steady[0] if steady else None,
          "launches": counts, "streams_equal_plain": 16 - len(recs),
          "near_ties": recs, "verify_rows_vs_twins": verify,
          "f32_plain_streams_equal": equal32})
    return counts, per_round


def _decode_route(cfg, params, prompt, rows, w, n):
    """Sequences rows [B·W, S + n] teacher-forced on the beam pool's decode
    route: each prompt of prompt [B, S] prefilled alone, its cache repeated
    for its W rows, then the B·W rows decoded at one position. Returns the
    route's logits [n, B·W, V] (the prefill's row first) and the f32 sums
    of the rows' log-probs, accumulated step by step as the scorer does."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    lt = cfg.num_hidden_layers
    caches, first = [], []
    for i in range(b):
        c = gen.init_kv_cache(cfg, 1, s + n, torch.bfloat16, prompt.device)
        lg, _ = gen.prefill(cfg, params, prompt[i: i + 1], c)
        caches.append(c)
        first.append(lg[0].float())
    owner = [i // w for i in range(b * w)]
    cache = [{nm: torch.cat([caches[o][li][nm] for o in owner])
              for nm in caches[0][li]} for li in range(lt)]
    logits = [torch.stack([first[o] for o in owner])]
    for step in range(1, n):
        lg, _ = gen.decode_step(cfg, params, rows[:, s - 1 + step: s + step],
                                cache, s - 1 + step)
        logits.append(lg.float())
    logits = torch.stack(logits)
    acc = torch.zeros(b * w, device=prompt.device)
    for step in range(n):
        acc = acc + torch.log_softmax(logits[step], -1).gather(
            -1, rows[:, s + step, None])[:, 0]
    return logits, acc


def _beam_traffic_u(cfg, params, fparams, dev, rng):
    """Traffic U: beam search through ``AwqCausalLM.generate`` on
    Mistral-7B, bs2 x 64-token prompts, num_beams 4, 64 new tokens, all 4
    beams returned, run once (its rows and scores read from the
    ``generate_beam_batched`` call the facade makes): tok/s, K5 and K3
    launches held exactly (every step after the first decodes the 8 beam
    rows at one position through K5). Each returned beam's score against
    its own teacher-forced sum of log-probs on the decode route the pool
    took (``_decode_route``), within 1e-3 of the sum; every row of that
    route held against the plain twins' forward by the teacher-forced
    rule; 8 seeded random continuations through the same route and twins,
    whose sums against the f32 forward's show whether the beams' own gap
    is the search's selection. Then the beam search in f32 on the plain
    path (``fparams``): each score against the plain f32 forward's sum,
    within 1e-3. Returns the launch counts."""
    import numpy as np
    import torch

    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import beam
    from autoawq_tpu_torch.serve.beam import generate_beam_batched

    w, n, lt, s = 4, 64, cfg.num_hidden_layers, 64
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (2, s))).to(dev)
    model = AwqCausalLM(cfg, params, device=dev)
    _build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _recorded(beam, "generate_beam_batched") as log:
        out = model.generate(prompt, max_new_tokens=n, num_beams=w,
                             num_return_sequences=w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = dict(_build.LAUNCHES)
    expect = {"fused_attn_step": lt * (n - 1), "fused_mlp": lt * (n - 1),
              "w4a16_gemv": 2 * 4 * lt, "w4a16_gemm": 0}
    _check_launches("U", counts, expect)
    [(_, res, _)] = log
    rows = torch.from_numpy(np.concatenate([r for r, _ in res])).to(dev)
    check(torch.equal(rows, out), "U: the facade's rows differ from "
          "generate_beam_batched's")
    scores = [sc for _, ss in res for sc in ss]
    owner = [i // w for i in range(2 * w)]
    # drawn apart from ``rng``, so the traffics after U keep their inputs
    rnd = torch.cat([prompt[owner], torch.from_numpy(np.random.default_rng(
        0).integers(0, cfg.vocab_size, (2 * w, n))).to(dev)], dim=1)
    route, sums = _decode_route(cfg, params, prompt, rows, w, n)
    r_route, r_sums = _decode_route(cfg, params, prompt, rnd, w, n)
    seqs = torch.cat([rows, rnd])
    twins = _twins(cfg, params, seqs)
    f32_sums = torch.log_softmax(twins[1][:, s - 1:-1], -1).gather(
        -1, seqs[:, s:, None])[..., 0].sum(-1).tolist()
    vs_twins = _rows_vs_twins("U decode route", [
        (i + off, s - 1 + step, lg[step, i])
        for off, lg in ((0, route), (2 * w, r_route))
        for i in range(2 * w) for step in range(n)], twins)
    del twins, route, r_route
    checks = []
    for i, sc in enumerate(scores):
        beam_sum = sc * n  # length penalty 1.0 over 64 generated tokens
        ref = float(sums[i])
        err, lim = abs(beam_sum - ref), 1e-3 * abs(ref)
        checks.append({"beam_sum": beam_sum, "teacher_forced_sum": ref,
                       "err": err, "limit": lim,
                       "f32_forward_sum": f32_sums[i]})
        check(err <= lim, f"U beam {i}: score sum {beam_sum:.4f} is "
              f"{err:.4g} from its teacher-forced sum {ref:.4f}, limit "
              f"{lim:.4g}")
    # beams in f32 on the plain path: scores against the f32 forward
    t = time.perf_counter()
    res32 = generate_beam_batched(cfg, fparams, list(prompt), n,
                                  num_beams=w, num_return_sequences=w,
                                  method="plain", dtype=torch.float32,
                                  device=dev)
    secs32 = time.perf_counter() - t
    rows32 = torch.from_numpy(np.concatenate([r for r, _ in res32])).to(dev)
    lp32 = torch.log_softmax(modules.forward(
        cfg, params, rows32, "plain", torch.float32)[:, s - 1:-1].float(), -1)
    sums32 = lp32.gather(-1, rows32[:, s:, None])[..., 0].sum(-1).tolist()
    errs32 = [abs(sc * n - ref) for sc, ref in zip(
        [sc for _, ss in res32 for sc in ss], sums32)]
    for i, (err, ref) in enumerate(zip(errs32, sums32)):
        check(err <= 1e-3 * abs(ref), f"U f32 beam {i}: score sum is "
              f"{err:.4g} from the f32 forward's {ref:.4f}")
    emit({"phase": "serve", "traffic": "U", "card": card(), "batch": 2,
          "prompt": s, "num_beams": w, "new_tokens": n,
          "tok_s": 2 * n / secs, "beam_row_tok_s": 2 * w * n / secs,
          "seconds": secs, "launches": counts,
          "launches_per_step": {kk: v / (n - 1) for kk, v in counts.items()
                                if kk in ("fused_attn_step", "fused_mlp")},
          "scores": checks, "decode_route_vs_twins": vs_twins,
          "route_minus_f32_sum": {
              "beams": [float(sums[i]) - f32_sums[i] for i in range(2 * w)],
              "random": [float(r_sums[i]) - f32_sums[2 * w + i]
                         for i in range(2 * w)]},
          "f32_plain": {"seconds": secs32, "score_errors": errs32,
                        "sums": sums32}})
    return counts


def _eviction_traffic_v(dev, rng):
    """Traffic V: TinyLlama bs1 through ``generate`` with ``max_seq_len``
    256, a 64-token prompt and 384 new tokens, so the cache rolls by 128
    rows twice: roll count, tok/s, launches held exactly (K1 44 and K3 22 a
    decode step); then the kernel path teacher-forced for 8 steps after the
    first roll against the plain twins (bf16 and f32) on copies of the
    rolled cache the run left. Returns the launch counts."""
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**TINYLLAMA)
    params = synth_zoo_params(cfg, 0, dev)
    lt, cap, n = cfg.num_hidden_layers, 256, 384
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, 64))).to(dev)
    rolls, rolled = [], []
    roll = gen.roll_kv

    def counted(caches, k):  # counts the rolls, keeps the first one's cache
        rolls.append(k)
        caches = roll(caches, k)
        if not rolled:
            rolled.extend({nm: c.clone() for nm, c in layer.items()}
                          for layer in caches)
        return caches

    gen.roll_kv = counted
    try:
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = gen.generate(cfg, params, prompt, n, max_seq_len=cap)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        gen.roll_kv = roll
    counts = dict(_build.LAUNCHES)
    check(len(rolls) == 2 and out.shape == (1, 64 + n),
          f"V: {len(rolls)} rolls, output {tuple(out.shape)}")
    _check_launches("V", counts, {"w4a16_gemv": 4 * lt + 2 * lt * (n - 1),
                                  "fused_mlp": lt * (n - 1),
                                  "fused_attn_step": 0})
    # the next steps after the first roll, of the three paths on copies of
    # the rolled cache the kernel path left
    cache = rolled
    runs = {"kernel": ("auto", torch.bfloat16),
            "plain": ("plain", torch.bfloat16),
            "plain_f32": ("plain", torch.float32)}
    caches = {kk: [{nm: (c.float() if dt == torch.float32 else c.clone())
                    for nm, c in layer.items()} for layer in cache]
              for kk, (_, dt) in runs.items()}
    rows = []
    pos = cap - gen.ROLL_STEP
    for i in range(8):
        tok = out[:, cap + i: cap + i + 1]
        lg = {kk: gen.decode_step(cfg, params, tok, caches[kk], pos + i, m,
                                  dt)[0] for kk, (m, dt) in runs.items()}
        ref = lg["plain_f32"]
        rows.append({"position_after_roll": pos + i,
                     "kernel_vs_f32": rel_err(lg["kernel"], ref)[1],
                     "plain_bf16_vs_f32": rel_err(lg["plain"], ref)[1],
                     "kernel_vs_plain": rel_err(lg["kernel"],
                                                lg["plain"])[1],
                     "position": pos + i})
    _check_teacher_forced("V after a roll", rows)
    emit({"phase": "serve", "traffic": "V", "card": card(), "batch": 1,
          "prompt": 64, "new_tokens": n, "max_seq_len": cap,
          "rolls": len(rolls), "roll_step": gen.ROLL_STEP, "tok_s": n / secs,
          "seconds": secs, "launches": counts,
          "launches_per_decode_step": {
              "w4a16_gemv": (counts["w4a16_gemv"] - 4 * lt) / (n - 1),
              "fused_mlp": counts["fused_mlp"] / (n - 1)},
          "kernel_vs_plain_after_roll": rows})
    del params, cache, caches
    return counts


def phase_serve(dev):
    """The rest of serving on the card: Mistral-7B at full width and depth
    (seed-0 W4 g128 weights drawn on the card, fused) through speculative
    decoding (S), the speculative slot pool (T) and beam search (U); then
    TinyLlama's windowed eviction (V). Returns (launch counts summed over
    the phase, launches per decode step or round of S, T, U and V)."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**MISTRAL)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    params = synth_zoo_params(cfg, 0, dev)
    torch.cuda.synchronize()
    emit({"phase": "serve", "model": "mistral-7b", "step": "synth",
          "layers": cfg.num_hidden_layers,
          "seconds": time.perf_counter() - t})
    t, mem = time.perf_counter(), torch.cuda.memory_allocated()
    fparams = _float_twin(params)
    torch.cuda.synchronize()
    emit({"phase": "serve", "model": "mistral-7b", "step": "f32 twin",
          "seconds": time.perf_counter() - t,
          "bytes": torch.cuda.memory_allocated() - mem})
    rng = np.random.default_rng(31)
    counts, per_step = {}, {}
    for name, fn in (("S", _spec_traffic_s), ("T", _spec_traffic_t),
                     ("U", _beam_traffic_u)):
        t = time.perf_counter()
        got = fn(cfg, params, fparams, dev, rng)
        if name == "T":
            got, per_step["T"] = got
        counts[name] = got
        emit({"phase": "serve", "traffic": name, "step": "seconds",
              "seconds": time.perf_counter() - t})
    del params, fparams
    torch.cuda.empty_cache()
    t = time.perf_counter()
    counts["V"] = _eviction_traffic_v(dev, rng)
    emit({"phase": "serve", "traffic": "V", "step": "seconds",
          "seconds": time.perf_counter() - t})
    lt = cfg.num_hidden_layers
    per_step["U"] = {"fused_attn_step": lt, "fused_mlp": lt}
    per_step["V"] = {"w4a16_gemv": 44, "fused_mlp": 22}
    names = set().union(*counts.values())
    total = {kk: sum(c.get(kk, 0) for c in counts.values()) for kk in names}
    return total, {t: {kk: per.get(kk, 0) for kk in KERNEL_META}
                   for t, per in per_step.items()}


def _unfused(cfg, params):
    """A fused tree of ``synth_zoo_params`` split back into q/k/v and
    gate/up (column slices of the port's layout, made contiguous), the
    layout LoRA trains on (``nn/fuse`` refuses adapters)."""
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    inter = cfg.intermediate_size

    def cols(lin, lo, hi):
        return {k: v[:, lo:hi].contiguous() for k, v in lin.items()}

    for lp in params["layers"]:
        qkv = lp["self_attn"].pop("qkv_proj")
        bounds = (0, nh * hd, (nh + nkv) * hd, (nh + 2 * nkv) * hd)
        for name, lo, hi in zip(("q_proj", "k_proj", "v_proj"), bounds,
                                bounds[1:]):
            lp["self_attn"][name] = cols(qkv, lo, hi)
        if "gate_up_proj" in lp["mlp"]:  # a dense MLP (MoE keeps its own)
            gu = lp["mlp"].pop("gate_up_proj")
            lp["mlp"]["gate_proj"] = cols(gu, 0, inter)
            lp["mlp"]["up_proj"] = cols(gu, inter, 2 * inter)
    return params


def _own_attn(params, layers):
    """The first ``layers`` layers of ``params`` with their own attention
    LIN dicts (sharing the tensors), so adapters added to them leave
    ``params`` as it is."""
    return {**params, "layers": [
        dict(lp, self_attn={n: dict(lin) for n, lin in
                            lp["self_attn"].items()})
        for lp in params["layers"][:layers]]}


def _grad_rows(got, ref, plain):
    """Per adapter gradient: relative L2 distances of the kernel route and
    the bf16 plain route from the f32 plain step, and whether the kernel
    route keeps within twice the plain route's plus the floor; beside them
    (not in the rule) the kernel route's distance from the bf16 plain
    route, relative to the f32 gradient's norm."""
    rows = []
    for g, r, p in zip(got, ref, plain):
        den = max(r.float().norm().item(), 1e-30)
        k = (g.float() - r.float()).norm().item() / den
        b = (p.float() - r.float()).norm().item() / den
        rows.append({"kernel_vs_f32": k, "plain_bf16_vs_f32": b,
                     "kernel_vs_plain_bf16": (g.float() - p.float()).norm()
                     .item() / den,
                     "ok": k <= 2 * b + TOL["train_grad_floor"]})
    return rows


def _train_grad_check(cfg, base_params, tokens, depth, dev, traffic="W",
                      targets=TRAIN_TARGETS):
    """Check (a) of a training traffic on the first ``depth`` layers: one
    step's loss and adapter gradients (A from ``add_lora``, B drawn
    nonzero so that A has a gradient) on the kernel route, held against
    the plain route in bf16 and in f32 by the teacher-forced style rule.
    An MoE model's plain runs replay the kernel route's expert choice
    (``moe_route(..., topi=)``), so that routing flips between the
    dtypes are not counted; the flip shares of the choices the runs would
    have made are reported and held as the e2e phase holds them."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.train import lora

    ccfg = dataclasses.replace(cfg, num_hidden_layers=depth)
    cut = _own_attn(base_params, depth)
    lora.add_lora(ccfg, cut, rank=TRAIN_RANK, seed=1, targets=targets)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for lp in cut["layers"]:
        for lin in lp["self_attn"].values():
            if "lora_b" in lin:
                lin["lora_b"] = torch.randn(lin["lora_b"].shape,
                                            generator=gen, device=dev) * 1e-2
    adapters, base = lora.split_lora(cut)
    tape = _RouteTape(1)
    chosen, free = [], {"plain": [], "plain_f32": []}
    runs = {}
    with tape if ccfg.is_moe else contextlib.nullcontext():
        for name, method, dt in (("kernel", "auto", torch.bfloat16),
                                 ("plain", "plain", torch.bfloat16),
                                 ("plain_f32", "plain", torch.float32)):
            if ccfg.is_moe and name == "kernel":
                tape.reset(record=chosen)
            elif ccfg.is_moe:
                tape.reset(replay=chosen, free=free[name])
            t = time.perf_counter()
            loss, grads = lora.lora_loss_and_grads(ccfg, adapters, base,
                                                   tokens, method, dt)
            torch.cuda.synchronize()
            runs[name] = (loss.item(), grads, time.perf_counter() - t)
    routing = None
    if ccfg.is_moe:
        routing = {"route_calls": len(chosen),
                   "kernel_flip_share": _flip_share(chosen,
                                                    free["plain_f32"]),
                   "plain_bf16_flip_share": _flip_share(
                       free["plain"], free["plain_f32"]),
                   "plain_runs_replay": "the kernel route's choice"}
        _check_routing(f"train {traffic} ({depth} layers)", routing)
    rows = _grad_rows(runs["kernel"][1], runs["plain_f32"][1],
                      runs["plain"][1])
    lk, lp_, lf = (runs[n][0] for n in ("kernel", "plain", "plain_f32"))
    loss_ok = abs(lk - lf) <= 2 * abs(lp_ - lf) + TOL[
        "train_grad_floor"] * abs(lf)
    check(loss_ok and all(r["ok"] for r in rows),
          f"train {traffic} ({depth} layers): kernel route outside the "
          f"rule: loss {lk:.6g} (plain {lp_:.6g}, f32 {lf:.6g}), "
          f"{sum(not r['ok'] for r in rows)} of {len(rows)} gradients")
    emit({"phase": "train", "step": "kernel_vs_plain", "traffic": traffic,
          "layers": depth, "loss": {"kernel": lk, "plain": lp_,
                                    "plain_f32": lf},
          "seconds": {n: r[2] for n, r in runs.items()},
          "routing": routing,
          "worst_kernel_vs_f32": max(r["kernel_vs_f32"] for r in rows),
          "worst_plain_bf16_vs_f32": max(r["plain_bf16_vs_f32"]
                                         for r in rows),
          "worst_kernel_vs_plain_bf16": max(r["kernel_vs_plain_bf16"]
                                            for r in rows),
          "gradients": rows})


def _train_ids(cfg, dev):
    """X's and Y's fixed batch: ``TRAIN_BATCH`` seeded ids."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(43).integers(
        0, cfg.vocab_size, TRAIN_BATCH)).to(dev)


def _moe_step_launches(cfg, routing, fixed):
    """One training step's exact launches: ``fixed`` (the attention's and
    the dense and shared MLPs') plus, for each MoE layer's recorded
    routing (``topi`` [T, k]) and each expert, two launches (gate_up and
    down) by its routed rows: none for 0 rows, K1 below ``WS_MIN_M`` (256)
    and K2 from there (``nn/modules._routed_rows``). Returns (launches,
    each MoE layer's rows per expert)."""
    import torch

    from autoawq_tpu_torch.ops.gemm import WS_MIN_M

    expect = dict(fixed)
    rows = []
    for topi in routing:
        per = torch.bincount(topi.flatten(),
                             minlength=cfg.num_experts).tolist()
        rows.append(per)
        for n in per:
            if n:
                k = "w4a16_gemm" if n >= WS_MIN_M else "w4a16_gemv"
                expect[k] = expect.get(k, 0) + 2
    return {k: n for k, n in expect.items() if n}, rows


def _lora_moe_traffic(traffic, model, cfg, base_params, targets, fixed, dev):
    """Checks (c) and (b) of traffic X or Y: rank-8 f32 adapters on
    ``targets``, one fixed batch of ``TRAIN_BATCH`` seeded ids, bf16,
    AdamW. (c) one step's launches held exactly against those its
    recorded routing implies (:func:`_moe_step_launches`), the step's ms
    (min of 3), training tokens/s, a profile of one step and the peak
    memory; (b) ``TRAIN_MOE_STEPS`` steps, the last loss below the first.
    Returns (the steps' launch counts, one step's launches, the trained
    adapters and the base)."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.train import lora

    tokens = _train_ids(cfg, dev)
    bf = torch.bfloat16
    params = _own_attn(base_params, cfg.num_hidden_layers)
    lora.add_lora(cfg, params, rank=TRAIN_RANK, seed=0, targets=targets)
    adapters, base = lora.split_lora(params)
    opt = lora.make_optimizer(adapters, "adamw", lr=TRAIN_LR)

    def step():
        return lora.lora_train_step_opt(cfg, adapters, base, opt, tokens,
                                        dtype=bf).item()

    routing = []
    seconds = {}
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with _RouteTape(1) as tape:
        tape.reset(record=routing)
        losses = [step()]
    torch.cuda.synchronize()
    per_step = dict(_build.LAUNCHES)
    got = {k: n for k, n in per_step.items() if n}
    expect, rows = _moe_step_launches(cfg, routing, fixed)
    check(got == expect, f"train {traffic}: launches a step {got}, "
          f"expected {expect} from the step's routing")
    counts = dict(per_step)
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    seconds["first_4_steps"] = time.perf_counter() - t
    t = time.perf_counter()
    prof = device_profile(lambda i: losses.append(step()), 1,
                          match=("w4a16_gemm", "DenseJob", "gemv",
                                 "prefill_attn", "dkv_kernel",
                                 "dq_kernel"), host_ops=False)
    seconds["profiled_step"] = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    while len(losses) < TRAIN_MOE_STEPS:
        losses.append(step())
    torch.cuda.synchronize()
    seconds["other_steps"] = time.perf_counter() - t
    for k in counts:
        counts[k] = _build.LAUNCHES[k]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train {traffic}: loss {losses[0]:.5g} -> {losses[-1]:.5g} over "
          f"{TRAIN_MOE_STEPS} AdamW steps")
    tok = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    emit({"phase": "train", "traffic": traffic, "model": model,
          "card": card(), "layers": cfg.num_hidden_layers,
          "batch": list(TRAIN_BATCH), "rank": TRAIN_RANK,
          "targets": list(targets), "lr": TRAIN_LR, "step_ms": step_ms,
          "step_ms_min": min(step_ms),
          "train_tokens_per_s": tok / (min(step_ms) / 1e3),
          "launches_per_step": got,
          "routed_rows_per_expert": rows, "losses": losses,
          "peak_memory_bytes": peak, "profile": prof, "seconds": seconds})
    return counts, per_step, adapters, base


def _fold_check(cfg, params, dev):
    """Check (d) of traffic Y: the repaired kv_b fold on the card. A
    greedy decode through the latent cache (kernel route, bf16) with the
    trained kv_b adapter, its logits held teacher-forced against the
    materialized forward's (``modules.forward``, kv_b through ``linear``
    with the adapter) by the e2e rule: within twice the bf16 plain
    forward's distance from the f32 plain forward, + 1e-3; the forwards
    replay the decode's expert choice. Beside it the plain route's f32
    latent decode (same choice) against the f32 forward, within
    ``TOL["mla_fold"]``: the adapter's fold alone, which a dropped
    adapter moves by far more."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.serve import generate as gen

    b, s, n = TRAIN_FOLD
    prompt = torch.from_numpy(np.random.default_rng(44).integers(
        0, cfg.vocab_size, (b, s))).to(dev)
    moe = sum("experts_stacked" in lp["mlp"] for lp in params["layers"])
    bf, f32 = torch.bfloat16, torch.float32

    def latent(method, dtype, tokens):
        caches = gen.init_kv_cache(cfg, b, s + n, dtype, dev)
        out = [gen.prefill(cfg, params, prompt, caches, method, dtype)[0]]
        for j in range(n):
            if len(tokens) == j:
                tokens.append(out[-1].argmax(-1)[:, None])
            out.append(gen.decode_step(cfg, params, tokens[j], caches, s + j,
                                       method, dtype)[0])
        return out

    rec, tokens = [], []
    with torch.no_grad(), _RouteTape(moe) as tape:
        tape.reset(record=rec)
        got = latent("auto", bf, tokens)
        seq = torch.cat([prompt] + tokens, dim=1)
        k = rec[0].shape[-1]
        whole = [torch.cat([rec[m].reshape(b, s, k)] + [
            rec[(j + 1) * moe + m].reshape(b, 1, k) for j in range(n)],
            dim=1).reshape(-1, k) for m in range(moe)]
        fwd = {}
        for name, dt in (("plain", bf), ("plain_f32", f32)):
            tape.reset(replay=whole)
            fwd[name] = modules.forward(cfg, params, seq, "plain", dt)[
                :, s - 1:]
        tape.reset(replay=rec)
        lat32 = latent("plain", f32, tokens)
    rows = [{"position": s - 1 + i,
             "kernel_vs_f32": rel_err(got[i], fwd["plain_f32"][:, i])[1],
             "plain_bf16_vs_f32": rel_err(fwd["plain"][:, i],
                                          fwd["plain_f32"][:, i])[1],
             "latent_f32_vs_materialized_f32": rel_err(
                 lat32[i], fwd["plain_f32"][:, i])[1]}
            for i in range(n + 1)]
    _check_teacher_forced("Y (d) latent decode vs materialized forward",
                          rows)
    worst = max(r["latent_f32_vs_materialized_f32"] for r in rows)
    check(worst <= TOL["mla_fold"], f"train Y (d): the f32 latent decode "
          f"is {worst:.3g} of the logit scale from the materialized "
          f"forward (limit {TOL['mla_fold']})")
    emit({"phase": "train", "step": "kv_b_fold", "traffic": "Y",
          "card": card(), "batch": b, "prompt": s, "decode_steps": n,
          "rows": rows})


def _train_kernel_rows(dev):
    """K2 at Mixtral's expert gate_up (4096 -> 28672) and down (14336 ->
    4096) at 512 routed rows (X's mean: 2048 tokens x top-2 / 8), K1 at
    V2-Lite's expert gate_up (2048 -> 2816) and down (1408 -> 2048) at 192
    (Y's mean: 2048 x top-6 / 64), each against its twin and timed with
    its bound, the twin and the library call, as the kernels phase times
    them."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    h, i = MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"]
    vh = DEEPSEEK_V2_LITE["hidden_size"]
    vi = DEEPSEEK_V2_LITE["moe_intermediate_size"]
    return [_gemm_case(None, kernel, f"train {case}", m, k, n, gs, True,
                       dev, iters=50, gen=gen)
            for kernel, case, m, k, n, gs in (
                ("w4a16_gemm", "X expert gate_up", 512, h, 2 * i, 128),
                ("w4a16_gemm", "X expert down", 512, i, h, 128),
                ("w4a16_gemv", "Y expert gate_up", 192, vh, 2 * vi,
                 MLA_MOE_GS),
                ("w4a16_gemv", "Y expert down", 192, vi, vh, MLA_MOE_GS))]


def _traffics_x_y(dev):
    """Traffics X (Mixtral-8x7B) and Y (DeepSeek-V2-Lite): LoRA through
    MoE and MLA on the card. Returns (launch counts, launches a step)."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.models.config import ModelConfig

    counts, per_step = {}, {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    cfg = dataclasses.replace(ModelConfig(**MIXTRAL),
                              num_hidden_layers=MIXTRAL_DEPTH)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    base_params = _unfused(cfg, synth_moe_on_card(cfg, 0, dev))
    torch.cuda.synchronize()
    emit({"phase": "train", "model": "mixtral-8x7b", "step": "synth",
          "layers": MIXTRAL_DEPTH,
          "published_layers": MIXTRAL["num_hidden_layers"],
          "cut": f"depth {MIXTRAL_DEPTH} of "
          f"{MIXTRAL['num_hidden_layers']} layers, published width",
          "seconds": time.perf_counter() - t})
    L = cfg.num_hidden_layers
    c, per_step["X"], _, _ = _lora_moe_traffic(
        "X", "mixtral-8x7b", cfg, base_params, TRAIN_TARGETS,
        {"w4a16_gemm": 4 * L, "prefill_attention": L,
         "prefill_attention_dkv": L, "prefill_attention_dq": L}, dev)
    add(c)
    t = time.perf_counter()
    _train_grad_check(cfg, base_params, _train_ids(cfg, dev),
                      TRAIN_MOE_CHECK_LAYERS, dev, "X", TRAIN_TARGETS)
    emit({"phase": "train", "traffic": "X", "step": "check (a) seconds",
          "seconds": time.perf_counter() - t})
    del base_params
    torch.cuda.empty_cache()

    cfg, base_params = _zoo_model(DEEPSEEK_V2_LITE, dev, V2_LITE_DEPTH,
                                  phase="train", gs=MLA_MOE_GS)
    L, dense = cfg.num_hidden_layers, cfg.first_k_dense_replace
    # a layer's q, kv_a, kv_b and o; a dense MLP's gate_up and down; a
    # MoE layer's shared experts' gate, up and down: K2 each at 2,048 rows
    c, per_step["Y"], adapters, base = _lora_moe_traffic(
        "Y", "deepseek-v2-lite", cfg, base_params, V2_LITE_TRAIN_TARGETS,
        {"w4a16_gemm": 4 * L + 2 * dense + 3 * (L - dense)}, dev)
    add(c)
    from autoawq_tpu_torch.train import lora

    t = time.perf_counter()
    _fold_check(cfg, lora.merge_lora(adapters, base), dev)
    del adapters, base
    emit({"phase": "train", "traffic": "Y", "step": "check (d) seconds",
          "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    _train_grad_check(cfg, base_params, _train_ids(cfg, dev),
                      TRAIN_MOE_CHECK_LAYERS, dev, "Y", V2_LITE_TRAIN_TARGETS)
    emit({"phase": "train", "traffic": "Y", "step": "check (a) seconds",
          "seconds": time.perf_counter() - t})
    del base_params
    torch.cuda.empty_cache()
    return counts, per_step


def phase_train(dev):
    """Traffic W: LoRA fine-tuning of a quantized 7B on the card.
    Mistral-7B-Instruct-v0.2's config at full width and depth (seed-0 W4
    g128 weights drawn on the card, unfused), rank-8 f32 adapters on q, k,
    v and o (``train/lora.add_lora``), one fixed batch of 4 x 512 seeded
    ids, bf16 activations, the kernel route (K2 forward, dx by the
    dequantized product; K4 forward, K10 / K11 backward). (c) exact
    launches of one step; the step's milliseconds (min of 3), training
    tokens/s, a profile of one step and the peak memory; (b) 16 AdamW
    steps, the last loss below the first; (a) on the first 2 and 16
    layers (``TRAIN_CHECK_LAYERS``), one step's loss and adapter gradients
    against the plain route in bf16 and in f32. Then traffics X and Y,
    LoRA through MoE and MLA (:func:`_traffics_x_y`), and K1 / K2 at
    their experts' shapes (:func:`_train_kernel_rows`). Returns (launch
    counts of the phase's kernel-route steps, launches a step of each
    traffic, the kernel rows)."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.train import lora
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**MISTRAL)
    layers = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    t = t_w = time.perf_counter()
    base_params = _unfused(cfg, synth_zoo_params(cfg, 0, dev))
    torch.cuda.synchronize()
    emit({"phase": "train", "model": "mistral-7b", "step": "synth",
          "layers": layers, "seconds": time.perf_counter() - t})
    tokens = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab_size, TRAIN_BATCH)).to(dev)
    bf = torch.bfloat16
    params = _own_attn(base_params, layers)
    lora.add_lora(cfg, params, rank=TRAIN_RANK, seed=0)
    adapters, base = lora.split_lora(params)
    opt = lora.make_optimizer(adapters, "adamw", lr=TRAIN_LR)

    # (c) one step's launches, then the step's time and profile
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses = [lora.lora_train_step_opt(cfg, adapters, base, opt, tokens,
                                       dtype=bf).item()]
    torch.cuda.synchronize()
    per_step = dict(_build.LAUNCHES)
    expect = {"w4a16_gemm": 7 * layers, "prefill_attention": layers,
              "prefill_attention_dkv": layers,
              "prefill_attention_dq": layers}
    wrong = {k: n for k, n in per_step.items() if n != expect.get(k, 0)}
    check(not wrong, f"train W: launches a step {wrong}, expected {expect} "
          "and no other kernel")
    counts = dict(per_step)
    step_ms = []
    for _ in range(3):
        t = time.perf_counter()
        losses.append(lora.lora_train_step_opt(cfg, adapters, base, opt,
                                               tokens, dtype=bf).item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    prof = device_profile(
        lambda i: losses.append(lora.lora_train_step_opt(
            cfg, adapters, base, opt, tokens, dtype=bf).item()), 1,
        match=("w4a16_gemm", "prefill_attn", "dkv_kernel", "dq_kernel"))
    peak = torch.cuda.max_memory_allocated()
    # (b) the rest of the 16 steps on the same batch
    while len(losses) < TRAIN_STEPS:
        losses.append(lora.lora_train_step_opt(cfg, adapters, base, opt,
                                               tokens, dtype=bf).item())
    torch.cuda.synchronize()
    for k_ in counts:
        counts[k_] = _build.LAUNCHES[k_]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train W: loss {losses[0]:.5g} -> {losses[-1]:.5g} over "
          f"{TRAIN_STEPS} AdamW steps")
    tok = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    emit({"phase": "train", "traffic": "W", "card": card(),
          "layers": layers, "batch": list(TRAIN_BATCH), "rank": TRAIN_RANK,
          "lr": TRAIN_LR, "step_ms": step_ms, "step_ms_min": min(step_ms),
          "train_tokens_per_s": tok / (min(step_ms) / 1e3),
          "launches_per_step": per_step, "losses": losses,
          "peak_memory_bytes": peak, "profile": prof})
    del adapters, base, params, opt
    # (a) gradients against the plain route, on the first layers
    for depth in TRAIN_CHECK_LAYERS:
        _train_grad_check(cfg, base_params, tokens, depth, dev)
    del base_params
    torch.cuda.empty_cache()
    emit({"phase": "train", "traffic": "W", "step": "seconds",
          "seconds": time.perf_counter() - t_w})
    t = time.perf_counter()
    more, steps = _traffics_x_y(dev)
    for k_, n in more.items():
        counts[k_] = counts.get(k_, 0) + n
    emit({"phase": "train", "traffic": "X and Y", "step": "seconds",
          "seconds": time.perf_counter() - t})
    return counts, {"W": per_step, **steps}, _train_kernel_rows(dev)


# --------------------------------------------------------------- parallel

# The parallel phase (tensor, expert and data parallelism on
# torch.distributed). The card is one H100 and NCCL refuses two ranks on
# one device, so the phase runs the code two ways: (a) a world of one over
# NCCL in this process; (b) two ranks sharing the card over gloo, spawned
# by the phase, whose collectives on CUDA tensors the port stages through
# host memory (parallel/distributed.py: STAGED). Neither is a collective's
# speed: gloo stages through the host. The slot engine over tensor 2 runs
# H's requests on TinyLlama cut to PARALLEL_ENGINE_LAYERS layers, Mixtral
# runs PARALLEL_MIXTRAL_LAYERS layers at full width, and the
# data-parallel calibration TinyLlama at full width on
# PARALLEL_CALIB_LAYERS layers and PARALLEL_CALIB ids (16 x 512).
PARALLEL_ENGINE_LAYERS = 16
# H's requests, 64 new tokens each (H's 128 cut for the time limit)
PARALLEL_ENGINE = dict(requests=16, prompt=64, new=64)
PARALLEL_MIXTRAL_LAYERS = 2
PARALLEL_CALIB = (16, 512)
PARALLEL_CALIB_LAYERS = 2
PARALLEL_DECODE_STEPS = 4  # teacher-forced bs8 decode steps at tensor 2
PARALLEL_TIMEOUT = 900  # seconds the two ranks may take together
# what the spawned ranks read from this module (a rehearsal on the CPU
# swaps them for tiny values, and the ranks import the module afresh)
# sequence parallelism at tensor 2: TinyLlama at full width,
# PARALLEL_SP_LAYERS layers, a 2 x 384 prompt and a 2 x 383 one (padded
# to 384 along S)
PARALLEL_SP_LAYERS = 2
PARALLEL_SP = (384, 383)
PARALLEL_SPEC = ("TINYLLAMA", "MIXTRAL", "PARALLEL_ENGINE_LAYERS",
                 "PARALLEL_ENGINE", "PARALLEL_MIXTRAL_LAYERS",
                 "PARALLEL_CALIB", "PARALLEL_CALIB_LAYERS",
                 "PARALLEL_DECODE_STEPS", "PARALLEL_SP_LAYERS",
                 "PARALLEL_SP")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _forced_logits(cfg, params, prompt, tokens, method, dtype, dev,
                   whole=False):
    """A prefill of ``prompt`` (every position's logits with ``whole``,
    else the last one's), then one decode step per entry of ``tokens``
    ([steps, B, 1]), teacher-forced. Returns the logits list and the
    prefill's and each decode step's launches (and a step's
    milliseconds)."""
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen

    b, s = prompt.shape
    _build.reset_launches()
    if whole:  # a prefill alone, every position's logits
        return ([modules.forward(cfg, params, prompt, method, dtype)],
                [{"launches": dict(_build.LAUNCHES)}])
    caches = gen.init_kv_cache(cfg, b, s + len(tokens), dtype, dev)
    out = [gen.prefill(cfg, params, prompt, caches, method, dtype)[0]]
    steps = [{"launches": dict(_build.LAUNCHES)}]
    for i, tok in enumerate(tokens):
        _sync(dev)
        _build.reset_launches()
        t = time.perf_counter()
        out.append(gen.decode_step(cfg, params, tok, caches, s + i, method,
                                   dtype)[0])
        _sync(dev)
        steps.append({"launches": dict(_build.LAUNCHES),
                      "ms": (time.perf_counter() - t) * 1e3})
    return out, steps


def _hold_rule(name, got, plain, f32):
    """Rows of ``got`` against the f32 plain run by the teacher-forced rule
    (within twice the bf16 plain run's distance, + 1e-3)."""
    rows = [{"position": i, "kernel_vs_f32": rel_err(g, f)[1],
             "plain_bf16_vs_f32": rel_err(p, f)[1]}
            for i, (g, p, f) in enumerate(zip(got, plain, f32))]
    _check_teacher_forced(name, rows)
    return rows


def _held_launches(name, steps, expect):
    for i, st in enumerate(steps):
        _check_launches(f"{name} {'prefill' if i == 0 else f'step {i}'}",
                        {k: v for k, v in st["launches"].items() if v},
                        expect[min(i, 1)])


def _rank_tp(rank, dev, rng):
    """TinyLlama at full width and depth over tensor 2: a 2 x 384 prefill
    (every position), A's bs1 x 64 prefill and a bs8 x 64 prefill, each
    with PARALLEL_DECODE_STEPS teacher-forced decode steps, each rank's
    launches held exactly, the logits held (rank 0) against the unsharded
    port's plain path in f32 by the teacher-forced rule; then the slot
    engine on H's requests at
    PARALLEL_ENGINE_LAYERS layers against the unsharded engine (rank 0),
    streams equal or parting only at a bf16 near tie."""
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch.api import AwqCausalLM
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.serve import batching
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve.batching import BatchingEngine
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**TINYLLAMA)
    full = synth_zoo_params(cfg, 0, dev)
    v, bf, f32 = cfg.vocab_size, torch.bfloat16, torch.float32
    pre = torch.from_numpy(rng.integers(0, v, (2, 384))).to(dev)
    dec = torch.from_numpy(rng.integers(0, v, (8, 64))).to(dev)
    toks = torch.from_numpy(rng.integers(
        0, v, (PARALLEL_DECODE_STEPS, 8, 1))).to(dev)
    n, ecfg = PARALLEL_ENGINE, dataclasses.replace(
        cfg, num_hidden_layers=PARALLEL_ENGINE_LAYERS)
    prompts = [rng.integers(0, v, (n["prompt"],))
               for _ in range(n["requests"])]
    cap = n["prompt"] + n["new"]
    one = torch.from_numpy(rng.integers(0, v, (1, 64))).to(dev)
    one_toks = torch.from_numpy(rng.integers(
        0, v, (PARALLEL_DECODE_STEPS, 1, 1))).to(dev)

    def seen(e):
        return lambda: ([None if r is None else r.id for r in e.slots],
                        e.pos.copy())

    def engine(c, p):
        """Streams, and each request's logits rows by position: the
        admission's prefill row (position 63) and every decode row."""
        eng = BatchingEngine(c, p, max_batch=8, max_seq_len=cap, device=dev)
        for i, pr in enumerate(prompts):
            eng.add_request(i, pr, n["new"])
        steps = {i: {} for i in range(len(prompts))}
        t = time.perf_counter()
        with _recorded(batching, "batched_decode_step", seen(eng)) as log, \
                _recorded(gen, "prefill") as plog:
            out = eng.run()
        _sync(dev)
        for _, res, (ids, pos) in log:
            for slot, i in enumerate(ids):
                if i is not None:
                    steps[i][int(pos[slot])] = res[0][slot]
        by_prompt = {tuple(pr.tolist()): i for i, pr in enumerate(prompts)}
        for a, res, _ in plog:
            i = by_prompt[tuple(a[2][0].tolist())]
            steps[i][n["prompt"] - 1] = res[0][0]
        return out, steps, time.perf_counter() - t

    ref = {}
    if rank == 0:  # the unsharded port: plain bf16 and f32, its engine
        for dt in (bf, f32):
            ref[("pre", dt)] = _forced_logits(cfg, full, pre, [], "plain",
                                              dt, dev, whole=True)[0]
            ref[("dec", dt)] = _forced_logits(cfg, full, dec, toks, "plain",
                                              dt, dev)[0]
            ref[("one", dt)] = _forced_logits(cfg, full, one, one_toks,
                                              "plain", dt, dev)[0]
        full16 = {**full, "layers": full["layers"][:PARALLEL_ENGINE_LAYERS]}
        ref["engine"] = engine(ecfg, full16)
    model = AwqCausalLM(cfg, full, device=dev).shard(build_mesh(tensor=2),
                                                     dtype=None)
    del full
    lcfg, lp = model.cfg, model.params
    L = cfg.num_hidden_layers
    got_pre, st_pre = _forced_logits(lcfg, lp, pre, [], "auto", bf, dev,
                                     whole=True)
    got_dec, st_dec = _forced_logits(lcfg, lp, dec, toks, "auto", bf, dev)
    got_one, st_one = _forced_logits(lcfg, lp, one, one_toks, "auto", bf,
                                     dev)
    # per rank: q, k, v, o, gate, up and down on K2 a layer (o and down
    # row shards) and K4 on the local heads; each decode step K5 on the
    # local heads and K8 on the local slice, one each a layer
    prefill = {"w4a16_gemm": 7 * L, "prefill_attention": L}
    _held_launches(f"parallel rank {rank} tensor 2 prefill 2 x 384",
                   st_pre, [prefill])
    _held_launches(f"parallel rank {rank} tensor 2 bs8 decode", st_dec,
                   [{"w4a16_gemm": 7 * L},  # 64 tokens: no K4 below 128
                    {"fused_attn_step": L, "fused_mlp3": L}])
    # A's bs1 x 64: every linear on K1 (64 rows, below K2's 256), o and
    # down row shards all-reduced after K1; each step q, k, v and o on K1
    # (B = 1 and a 68-row cache: no K5) and K8 on the local slice
    _held_launches(f"parallel rank {rank} tensor 2 bs1 decode", st_one,
                   [{"w4a16_gemv": 7 * L},
                    {"w4a16_gemv": 4 * L, "fused_mlp3": L}])
    for traffic, st in (("bs8 x 64 decode", st_dec),
                        ("bs1 x 64 decode", st_one)):
        emit({"phase": "parallel", "rank": rank, "backend": "gloo",
              "model": "tinyllama", "tensor": 2, "traffic": traffic,
              "step_ms": [s["ms"] for s in st[1:]],
              "launches_per_step": st[1]["launches"]})
    if rank == 0:
        rows = _hold_rule("parallel tensor 2 prefill 2 x 384", got_pre,
                          ref[("pre", bf)], ref[("pre", f32)])
        rows += _hold_rule("parallel tensor 2 bs8 decode", got_dec,
                           ref[("dec", bf)], ref[("dec", f32)])
        rows += _hold_rule("parallel tensor 2 bs1 decode", got_one,
                           ref[("one", bf)], ref[("one", f32)])
        emit({"phase": "parallel", "step": "tensor 2 vs unsharded f32",
              "rows": rows})
    del got_pre
    ref.pop(("pre", bf), None), ref.pop(("pre", f32), None)
    lp16 = {**lp, "layers": lp["layers"][:PARALLEL_ENGINE_LAYERS]}
    got, steps, secs = engine(dataclasses.replace(
        lcfg, num_hidden_layers=PARALLEL_ENGINE_LAYERS), lp16)
    emit({"phase": "parallel", "rank": rank, "backend": "gloo",
          "model": "tinyllama", "tensor": 2, "traffic": "slot engine",
          "layers": PARALLEL_ENGINE_LAYERS, **n, "seconds": secs})
    if rank == 0:
        want, wsteps, wsecs = ref["engine"]
        ids = range(len(prompts))
        seqs = torch.from_numpy(np.stack([np.concatenate(
            [prompts[i], want[i]]) for i in ids])).to(dev)
        recs = []
        for lo in range(0, len(prompts), 8):
            wave = list(ids)[lo:lo + 8]
            twins = _twins(ecfg, full16, seqs[wave])
            recs += _near_ties(
                "parallel slot engine tensor 2", n["prompt"],
                [got[i] for i in wave], [want[i] for i in wave],
                {b: {t: (0, r) for t, r in steps[i].items()}
                 for b, i in enumerate(wave)},
                {b: wsteps[i] for b, i in enumerate(wave)}, twins, first=0)
            del twins
        emit({"phase": "parallel", "step": "slot engine vs unsharded",
              "unsharded_seconds": wsecs,
              "equal_streams": sum(r["equal"] for r in recs),
              "streams": len(recs),
              "partings": [r for r in recs if not r["equal"]]})


def _rank_sp(rank, dev, rng):
    """Sequence parallelism over tensor 2: TinyLlama at full width,
    ``PARALLEL_SP_LAYERS`` layers, ``forward(...,
    sequence_parallel=mesh.axis("tensor"))`` on each prompt of
    ``PARALLEL_SP`` (2 x 384, and 2 x 383 padded to 384 along S). Each
    rank's launches held exactly (q, k, v, o, gate, up and down on K2 over
    the gathered sequence, K4 on the rank's heads, a layer) and its staged
    collectives (an all-gather a block and one before the head, the o
    all-reduce and the down reduce-scatter a block); the logits held
    (rank 0) against the unsharded port's plain path in f32 by the
    teacher-forced rule, and beside the same rank's replicated
    tensor-parallel forward. The host ms are reported, and are not a speed:
    gloo stages the collectives through host memory and the ranks share
    the card."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.api import AwqCausalLM
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.parallel import distributed as pd
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = dataclasses.replace(ModelConfig(**TINYLLAMA),
                              num_hidden_layers=PARALLEL_SP_LAYERS)
    L = cfg.num_hidden_layers
    full = synth_zoo_params(cfg, 0, dev)
    bf, f32 = torch.bfloat16, torch.float32
    prompts = {s: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (2, s))).to(dev)
               for s in PARALLEL_SP}
    ref = {}
    if rank == 0:  # the unsharded port's plain path
        for s, p in prompts.items():
            for dt in (bf, f32):
                ref[(s, dt)] = modules.forward(cfg, full, p, "plain", dt)
    mesh = build_mesh(tensor=2)
    model = AwqCausalLM(cfg, full, device=dev).shard(mesh, dtype=None)
    del full
    rows = []
    for s, p in prompts.items():
        name = f"parallel rank {rank} sequence parallel 2 x {s}"
        before = dict(pd.STAGED)
        _sync(dev)
        _build.reset_launches()
        t = time.perf_counter()
        got = modules.forward(model.cfg, model.params, p, dtype=bf,
                              sequence_parallel=mesh.axis("tensor"))
        _sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        staged = {k: n - before.get(k, 0) for k, n in pd.STAGED.items()
                  if n != before.get(k, 0)}
        want = {"w4a16_gemm": 7 * L, "prefill_attention": L}
        check(launches == want, f"{name}: launches {launches}, expected "
              f"{want}")
        want = {"all_gather": L + 1, "all_reduce": L, "reduce_scatter": L}
        check(staged == want, f"{name}: staged collectives {staged}, "
              f"expected {want}")
        tp = modules.forward(model.cfg, model.params, p, dtype=bf)
        check(tuple(got.shape) == (2, s, cfg.vocab_size)
              and bool(torch.isfinite(got).all()), f"{name}: logits of "
              f"shape {tuple(got.shape)}, or not finite")
        emit({"phase": "parallel", "rank": rank, "backend": "gloo",
              "model": "tinyllama", "layers": L, "tensor": 2,
              "traffic": f"sequence parallel 2 x {s}", "host_ms": ms,
              "note": "host ms of two gloo ranks sharing one card, "
              "collectives staged through host memory: not a speed",
              "staged_collectives": staged, "launches": launches,
              "sp_vs_replicated_tp_bf16": rel_err(got, tp)[1]})
        if rank == 0:
            rows += _hold_rule(f"parallel sequence parallel 2 x {s}", [got],
                               [ref[(s, bf)]], [ref[(s, f32)]])
    if rank == 0:
        emit({"phase": "parallel", "step": "sequence parallel vs "
              "unsharded f32", "rows": rows})


def _rank_ep(rank, dev, rng):
    """Mixtral-8x7B at full width, PARALLEL_MIXTRAL_LAYERS layers, experts
    over an expert axis of 2 under both dispatch schemes: E's bs1 step
    (prefill 64 and two teacher-forced decode steps) and F's 8 x 512
    prefill (every position), the f32 run's expert choice replayed in
    every run (rank 0 records it and sends it), each rank's launches held
    exactly, the logits held (rank 0) against the f32 plain run by the
    teacher-forced rule and beside the world of one's kernel path."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from autoawq_tpu_torch.api import AwqCausalLM
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.parallel.mesh import build_mesh

    cfg = dataclasses.replace(ModelConfig(**MIXTRAL),
                              num_hidden_layers=PARALLEL_MIXTRAL_LAYERS)
    full = synth_moe_on_card(cfg, 0, dev)
    v, bf, f32 = cfg.vocab_size, torch.bfloat16, torch.float32
    e_prompt = torch.from_numpy(rng.integers(0, v, (1, 64))).to(dev)
    e_toks = torch.from_numpy(rng.integers(0, v, (2, 1, 1))).to(dev)
    f_prompt = torch.from_numpy(rng.integers(0, v, (8, 512))).to(dev)
    L = cfg.num_hidden_layers
    tape = _RouteTape(L)

    def runs(params, method, dtype, c=cfg):
        e, st = _forced_logits(c, params, e_prompt, e_toks, method, dtype,
                               dev)
        f, fst = _forced_logits(c, params, f_prompt, [], method, dtype, dev,
                                whole=True)
        return e + f, st, fst

    record = [None]
    ref = {}
    with tape:
        if rank == 0:
            rec = []
            tape.reset(record=rec)
            ref["f32"] = runs(full, "plain", f32)[0]
            record = [[t.cpu() for t in rec]]
            tape.reset(replay=rec)
            ref["bf16"] = runs(full, "plain", bf)[0]
            tape.reset(replay=rec)
            ref["one"] = runs(full, "auto", bf)[0]
        dist.broadcast_object_list(record, src=0)
        rec = [t.to(dev) for t in record[0]]
        for scheme in ("replicate", "a2a"):
            m = AwqCausalLM(cfg, full, device=dev).shard(
                build_mesh(expert=2), dtype=None, moe_dispatch=scheme)
            tape.reset(replay=rec)
            got, st, fst = runs(m.params, "auto", bf, m.cfg)
            name = f"parallel rank {rank} expert 2 {scheme}"
            _held_launches(f"{name} E", st, [
                {"w4a16_gemv": 2 * L, "moe_gemm": 2 * L},
                {"w4a16_gemv": 2 * L, "moe_gemm": 2 * L}])
            _held_launches(f"{name} F", fst, [
                {"w4a16_gemm": 2 * L, "prefill_attention": L,
                 "moe_gemm": 2 * L}])
            emit({"phase": "parallel", "rank": rank, "backend": "gloo",
                  "model": "mixtral", "layers": L, "expert": 2,
                  "dispatch": scheme, "traffic": "E bs1 decode",
                  "step_ms": [s["ms"] for s in st[1:]]})
            if rank == 0:
                rows = _hold_rule(f"parallel expert 2 {scheme}", got,
                                  ref["bf16"], ref["f32"])
                for r, g, o in zip(rows, got, ref["one"]):
                    r["vs_world_of_one"] = rel_err(g, o)[1]
                emit({"phase": "parallel", "step": f"expert 2 {scheme}",
                      "rows": rows})
            del m, got


def _rank_dp(rank, dev, rng):
    """Data-parallel AWQ calibration: TinyLlama at full width on
    PARALLEL_CALIB_LAYERS layers, data 2 against one process (rank 0) on
    the same seeded ids, clip search off and on, with the CPU tests'
    bounds: layer 0's scales within rtol 1e-4 / atol 1e-5, >= 99.9% (off)
    or 99% (on) of the tree's elements within 1e-4. With the clip search
    off the logits are held within 5e-3 + 5e-3 * max |logit|, looser than
    the CPU tests' element-wise rtol = atol = 5e-3: at full width the sums'
    order flips an element or two of the tree by one grid step (a close
    share of 0.99999999), which moves a logit by ~0.04. With it on, more
    grid ties flip, so the close share alone holds that leg, as on the
    CPU."""
    import dataclasses

    import numpy as np
    import torch

    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
    from autoawq_tpu_torch.utils.tree import tensor_leaves

    cfg = dataclasses.replace(ModelConfig(**TINYLLAMA),
                              num_hidden_layers=PARALLEL_CALIB_LAYERS)
    fp = _outlier_fp(cfg, dev)
    calib = rng.integers(0, cfg.vocab_size, PARALLEL_CALIB)
    qcfg = AwqConfig(q_group_size=128, zero_point=True)
    mesh = build_mesh(data=2)
    tok = torch.from_numpy(calib[:2]).to(dev)
    for clip, share in ((False, 0.999), (True, 0.99)):
        t = time.perf_counter()
        q = AwqQuantizer(cfg, qcfg, fp, calib, progress=False,
                         apply_clip=clip, mesh=mesh, device=dev)
        got = q.quantize()
        secs = time.perf_counter() - t
        emit({"phase": "parallel", "rank": rank, "backend": "gloo",
              "step": "data 2 calibration", "clip": clip, "seconds": secs})
        if rank:
            continue
        t = time.perf_counter()
        q1 = AwqQuantizer(cfg, qcfg, fp, calib, progress=False,
                          apply_clip=clip, device=dev)
        want = q1.quantize()
        secs1 = time.perf_counter() - t
        s_ok = all(torch.allclose(a[1], b[1], rtol=1e-4, atol=1e-5)
                   for a, b in zip(q.all_scales[0], q1.all_scales[0]))
        n_close = n_all = 0
        for a, b in zip(tensor_leaves(got), tensor_leaves(want)):
            a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
            n_close += int(np.isclose(a, b, rtol=1e-4, atol=1e-4).sum())
            n_all += a.size
        lg = [modules.forward(cfg, _to(tree, dev), tok, "plain",
                              torch.float32) for tree in (got, want)]
        d = (lg[0] - lg[1]).abs().max().item()
        lim = None if clip else 5e-3 + 5e-3 * lg[1].abs().max().item()
        check(s_ok and n_close / n_all >= share and (clip or d <= lim),
              f"parallel data 2 calibration (clip {clip}): scales "
              f"{s_ok}, close share {n_close / n_all:.5f}, logits {d:.3g} "
              f"(limit {lim})")
        emit({"phase": "parallel", "step": "data 2 vs one process",
              "clip": clip, "scales_close": s_ok,
              "close_share": n_close / n_all, "logits_max_abs": d,
              "logits_limit": lim, "one_process_seconds": secs1})


def _to(tree, dev):
    from autoawq_tpu_torch.utils.tree import to_device

    return to_device(tree, dev)


def _world_rank(rank, world, port, tmp, device, spec, phase, parts):
    """One rank of a phase's gloo world (spawned): it runs the named
    ``parts`` of this module in order, in inference mode but for
    ``GRAD_PARTS``; its output goes to a file the phase prints after the
    join, its failures to another."""
    import traceback

    import numpy as np
    import torch

    from autoawq_tpu_torch.parallel import distributed as pd

    globals().update(spec)
    out = open(os.path.join(tmp, f"rank{rank}.out"), "w")
    sys.stdout = out
    err = None
    try:
        dev = pd.initialize(init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, backend="gloo",
                            device=device)
        for name in parts:
            t = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if name not in GRAD_PARTS:
                    stack.enter_context(torch.inference_mode())
                globals()[name](rank, dev, np.random.default_rng(0))
            emit({"phase": phase, "rank": rank, "part": name,
                  "seconds": time.perf_counter() - t})
        emit({"phase": phase, "rank": rank, "staged_collectives":
              dict(pd.STAGED), "note": "gloo collectives and point-to-point "
              "transfers on CUDA tensors, staged through host memory by "
              "design"})
    except Exception:  # reported by the phase, which fails the run
        err = traceback.format_exc()
    finally:
        out.flush()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"failures": failures, "error": err}, f)
        torch.distributed.destroy_process_group()


def _spawn_world(world, phase, parts, spec_names, dev):
    """Start ``world`` gloo ranks sharing the card, each running
    ``parts``; returns (context, scratch directory) without waiting."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    spec = {k: globals()[k] for k in spec_names}
    ctx = mp.start_processes(_world_rank, args=(
        world, _free_port(), tmp, str(dev), spec, phase, parts),
        nprocs=world, join=False, start_method="spawn")
    return ctx, tmp


def _join_world(ctx, tmp, world, phase, deadline):
    """Wait for the ranks until ``deadline`` (``time.time()``), print
    their output, and fail the run on a rank's failure, error or
    absence."""
    done = False
    while not done:
        try:
            done = ctx.join(timeout=max(1, deadline - time.time()))
        except Exception as e:  # a rank exited with an error
            check(False, f"{phase}: a rank failed: {e}")
            done = True
        if not done and time.time() >= deadline:
            for p in ctx.processes:
                p.kill()
            check(False, f"{phase}: the ranks did not finish in time")
            done = True
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.out")
        if os.path.exists(path):
            with open(path) as f:
                sys.stdout.write(f.read())
        res_path = os.path.join(tmp, f"rank{r}.json")
        if not os.path.exists(res_path):
            check(False, f"{phase} rank {r}: no result")
            continue
        with open(res_path) as f:
            res = json.load(f)
        for what in res["failures"]:
            check(False, f"rank {r}: {what}")
        check(res["error"] is None, f"{phase} rank {r} raised: "
              f"{res['error']}")
    shutil.rmtree(tmp, ignore_errors=True)


def _world_of_one(dev):
    """(a): TinyLlama at full width and depth (seed 0, fused) through
    ``shard(build_mesh(tensor=1))`` in a world of one over NCCL: an
    all-reduce over the one rank is the identity, the tree is the model's
    own, and A's step (bs1 x 64) and C's shape (bs8 x 64, K5) give the
    unsharded port's greedy streams exactly, with A's and C's launches a
    step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from autoawq_tpu_torch.api import AwqCausalLM
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.parallel import distributed as pd
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**TINYLLAMA)
    params = synth_zoo_params(cfg, 0, dev)
    pd.initialize(init_method=f"tcp://127.0.0.1:{_free_port()}",
                  world_size=1, rank=0, device=dev)
    try:
        backend = dist.get_backend()
        mesh = build_mesh(tensor=1)
        x = torch.randn(8, 2048, device=dev)
        check(torch.equal(pd.all_reduce(x, mesh.axis("tensor")), x),
              f"parallel world of one: {backend} all-reduce is not the "
              "identity")
        m = AwqCausalLM(cfg, params, device=dev).shard(mesh, dtype=None)
        check(m.params is params and m.cfg is cfg,
              "parallel world of one: shard changed the tree")
        rng = np.random.default_rng(0)
        L = cfg.num_hidden_layers
        for name, b, expect in (
                ("A", 1, {"w4a16_gemv": 2 * L, "fused_mlp": L}),
                ("C", 8, {"fused_attn_step": L, "fused_mlp": L})):
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, 64))).to(dev)
            streams = [gen.generate(c, p, prompt, 16, dtype=torch.bfloat16,
                                    max_seq_len=128).cpu()
                       for c, p in ((m.cfg, m.params), (cfg, params))]
            check(torch.equal(*streams), f"parallel world of one {name}: "
                  "streams differ from the unsharded port's")
            caches = gen.init_kv_cache(cfg, b, 128, torch.bfloat16, dev)
            gen.prefill(m.cfg, m.params, prompt, caches)
            tok = streams[0][:, 64:65].to(dev)
            _sync(dev)
            _build.reset_launches()
            t = time.perf_counter()
            gen.decode_step(m.cfg, m.params, tok, caches, 64)
            _sync(dev)
            ms = (time.perf_counter() - t) * 1e3
            got = {k: v for k, v in _build.LAUNCHES.items() if v}
            _check_launches(f"parallel world of one {name}", got, expect)
            emit({"phase": "parallel", "rank": 0, "backend": backend,
                  "world": 1, "model": "tinyllama", "traffic": name,
                  "batch": b, "streams_equal": torch.equal(*streams),
                  "step_ms": ms, "launches_per_step": got})
    finally:
        dist.destroy_process_group()


def _parallel_kernel_rows(dev):
    """K1, K2, K5, K6 and K8 against their twins at a rank's shapes under
    tensor 2 (TinyLlama: qkv 2048->1280, o 1024->2048 a row shard, gate /
    up 2048->2816, down 2816->2048 a row shard; K5 on 16/2 heads) and
    expert 2 (Mixtral: 4 of 8 experts a rank), timed with their bounds and
    library calls as the kernels phase times them."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.utils.synth import synth_qlin

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    t = TINYLLAMA
    h, hd, i2 = t["hidden_size"], t["head_dim"], t["intermediate_size"] // 2
    nh, nkv = t["num_attention_heads"] // 2, t["num_key_value_heads"] // 2
    shapes = {"qkv": (h, (nh + 2 * nkv) * hd),
              "o (row shard)": (nh * hd, h), "gate / up": (h, i2),
              "down (row shard)": (i2, h)}
    rows = []
    for case in ("qkv", "o (row shard)"):
        rows.append(_gemm_case(rng, "w4a16_gemv", f"tensor 2 {case}", 1,
                               *shapes[case], 128, True, dev))
    for case, (k, n) in shapes.items():
        rows.append(_gemm_case(rng, "w4a16_gemm", f"tensor 2 {case}", 768,
                               k, n, 128, True, dev))
    local = dict(t, num_attention_heads=nh, num_key_value_heads=nkv)
    rows.append(_k5_case(rng, f"tensor 2: TinyLlama {nh}/{nkv} heads", local,
                         8, 128, 127, dev))
    for m in (1, 8):
        rows.append(_mlp3_case(rng, f"tensor 2: TinyLlama M={m}", m, h, i2,
                               "silu", dev))
    h, inter = MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"]
    gu = synth_qlin(gen, h, 2 * inter, experts=4)
    dn = synth_qlin(gen, inter, h, experts=4)
    rows.append(_moe_case(gen, "expert 2: E decode, gate_up, 4 experts",
                          gu, 1, dev))
    rows.append(_moe_case(gen, "expert 2: F prefill, gate_up, 4 experts",
                          gu, 4096, dev, iters=10))
    rows.append(_moe_case(gen, "expert 2: F prefill, down, 4 experts", dn,
                          4096, dev, iters=10))
    return rows


def phase_parallel(dev):
    """Tensor, expert and data parallelism on the card: the two gloo ranks
    (b) spawned first, the world of one over NCCL (a) while they start,
    then their results, then the kernels at a rank's shapes."""
    ctx, tmp = _spawn_world(2, "parallel", ("_rank_tp", "_rank_ep",
                                            "_rank_dp", "_rank_sp"),
                            PARALLEL_SPEC, dev)
    t0 = time.perf_counter()
    try:
        _world_of_one(dev)
    finally:
        _join_world(ctx, tmp, 2, "parallel",
                    time.time() + PARALLEL_TIMEOUT)
    emit({"phase": "parallel", "step": "ranks", "seconds":
          time.perf_counter() - t0})
    _parallel_kernel_rows(dev)


# --------------------------------------------------------------- pipeline

# The pipeline phase (GPipe stages, with tensor parallelism inside each).
# As in the parallel phase, NCCL refuses two ranks on one device, so (a)
# runs a world of one over NCCL in this process and (b)-(d) spawn gloo
# ranks on the one card, whose collectives and point-to-point transfers
# on CUDA tensors the port stages through host memory: no number of
# theirs is a speed. (b) Mistral-7B at full width, PIPELINE_DEPTH of its
# 32 layers, W's batch in 4 microbatches; (c) TinyLlama at full width and
# depth, B's shape in 2; (d) MPT-7B and DeepSeek-V2-Lite at full width,
# PIPELINE_BREADTH_DEPTH layers (V2-Lite with first_k_dense_replace 0, so
# that both are MoE layers).
PIPELINE_DEPTH = 8
PIPELINE_W = (4, 512, 4)  # batch, length, microbatches
PIPELINE_TP = (2, 384, 2)
PIPELINE_ONE = (4, 384, 4)  # (a): TinyLlama in a world of one
PIPELINE_BREADTH_DEPTH = 2
PIPELINE_BREADTH = (2, 256, 2)  # (d)'s pipelined prefill: K2 at M = 256
PIPELINE_LR = 1e-3
PIPELINE_TIMEOUT = 600  # seconds the ranks may take
PIPELINE_SPEC = ("TINYLLAMA", "MISTRAL", "MPT7B", "DEEPSEEK_V2_LITE",
                 "MLA_MOE_GS", "PIPELINE_DEPTH", "PIPELINE_W", "PIPELINE_TP",
                 "PIPELINE_BREADTH_DEPTH", "PIPELINE_BREADTH", "PIPELINE_LR",
                 "PARALLEL_DECODE_STEPS", "TRAIN_RANK")
# the spawned parts that record autograd (every other runs in inference
# mode)
GRAD_PARTS = ("_rank_pp_mistral", "_rank_pp_tp")
COL_LINS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")


def _pp_adapters(cfg, params, targets, dev):
    """Rank-8 f32 adapters on ``targets`` (``add_lora``, seed 0), in place,
    with lora_b drawn nonzero (seed 2, std 1e-2) so that lora_a has a
    gradient, as W's check draws them."""
    import torch

    from autoawq_tpu_torch.train import lora

    lora.add_lora(cfg, params, rank=TRAIN_RANK, targets=targets, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for lp in params["layers"]:
        for sub in (lp["self_attn"], lp["mlp"]):
            for lin in sub.values():
                if isinstance(lin, dict) and "lora_b" in lin:
                    lin["lora_b"] = torch.randn(
                        lin["lora_b"].shape, generator=gen, device=dev) * 1e-2
    return params


def _adapter_paths(tree, prefix=""):
    """The adapter leaves of a tree by dotted path (detached clones)."""
    items = (enumerate(tree) if isinstance(tree, list) else tree.items())
    out = {}
    for k, v in items:
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_adapter_paths(v, path))
        elif str(k).startswith("lora_"):
            out[path] = v.detach().clone()
    return out


def _fresh_adapters(tree):
    """A copy of the tree's containers with the adapters cloned (a step
    updates them in place)."""
    if isinstance(tree, dict):
        return {k: (v.detach().clone() if k.startswith("lora_")
                    else _fresh_adapters(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fresh_adapters(v) for v in tree]
    return tree


def _ref_step(cfg, params, tokens, method, dtype):
    """The world of one's ``lora_train_step`` on a copy of the adapters:
    (loss, each adapter's update by path, seconds)."""
    import torch

    from autoawq_tpu_torch.train import lora

    tree = _fresh_adapters(params)
    old = _adapter_paths(tree)
    adapters, base = lora.split_lora(tree)
    t = time.perf_counter()
    loss, new = lora.lora_train_step(cfg, adapters, base, tokens, PIPELINE_LR,
                                     method, dtype)
    loss = loss.item()
    secs = time.perf_counter() - t
    upd = {p: old[p] - v for p, v in _adapter_paths(new).items()}
    del tree, adapters, base, new
    torch.cuda.empty_cache()
    return loss, upd, secs


def _held_step(name, got_loss, got_upd, refs):
    """A step's loss and adapter updates against the world of one's plain
    steps in f32 and bf16 by W's rule (within twice the bf16 step's
    distance from f32, + 1e-2). ``got_upd`` maps each update to the path
    and slice of the whole-model update it is."""
    (lf, f32, _), (lp_, bf, _) = refs["f32"], refs["bf16"]
    got, ref, plain = [], [], []
    for (path, sl), g in got_upd.items():
        got.append(g)
        ref.append(f32[path][sl])
        plain.append(bf[path][sl])
    rows = _grad_rows(got, ref, plain)
    loss_ok = abs(got_loss - lf) <= 2 * abs(lp_ - lf) + TOL[
        "train_grad_floor"] * abs(lf)
    check(math.isfinite(got_loss) and loss_ok and all(r["ok"] for r in rows),
          f"{name}: outside W's rule: loss {got_loss:.6g} (plain "
          f"{lp_:.6g}, f32 {lf:.6g}), {sum(not r['ok'] for r in rows)} of "
          f"{len(rows)} adapter updates")
    return {"loss": {"pipelined": got_loss, "plain": lp_, "plain_f32": lf},
            "updates": len(rows),
            "worst_kernel_vs_f32": max(r["kernel_vs_f32"] for r in rows),
            "worst_plain_bf16_vs_f32": max(r["plain_bf16_vs_f32"]
                                           for r in rows)}


def _stage_updates(mesh, old, new, per):
    """A stage rank's adapter updates keyed by (whole-model path, the
    slice of the whole update it is: a column shard's lora_b columns, a
    row shard's lora_a rows)."""
    t, ti = mesh.size("tensor"), mesh.index("tensor")
    out = {}
    for path, v in _adapter_paths(new).items():
        _, i, sub, lin, leaf = path.split(".")
        li = mesh.index("pipe") * per + int(i)
        g = old[path] - v
        sl = (slice(None),)
        if t > 1 and leaf == "lora_b" and lin in COL_LINS:
            n = g.shape[1]
            sl = (slice(None), slice(ti * n, (ti + 1) * n))
        elif t > 1 and leaf == "lora_a" and lin not in COL_LINS:
            n = g.shape[0]
            sl = (slice(ti * n, (ti + 1) * n),)
        out[(f"layers.{li}.{sub}.{lin}.{leaf}", sl)] = g
    return out


def _pp_part(name, rank, cfg, params, tokens, mesh, m, expect, refs,
             dev):
    """``pipeline_forward`` and one ``pipeline_lora_step`` of ``params``
    (adapters included) on ``mesh``: each rank's launches held exactly
    (``expect``: the forward's, then the step's), the logits (rank 0) by
    the teacher-forced rule and the step by W's, both against the world of
    one's plain runs ``refs`` (f32 and bf16 forward logits and steps);
    host ms of each, the backend named."""
    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.parallel import pipeline as pp
    from autoawq_tpu_torch.train import lora

    bf = torch.bfloat16
    pparams = pp.to_pipeline(cfg, _fresh_adapters(params), mesh, device=dev)
    per = cfg.num_hidden_layers // mesh.size("pipe")
    where = {a: mesh.index(a) for a in mesh.axis_names}
    _sync(dev)
    _build.reset_launches()
    t = time.perf_counter()
    with torch.no_grad():
        logits = pp.pipeline_forward(cfg, pparams, tokens, mesh, m,
                                     dtype=bf)
    _sync(dev)
    fwd_ms = (time.perf_counter() - t) * 1e3
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    _check_launches(f"{name} rank {rank} forward", got, expect[0])
    if rank == 0:
        rows = _hold_rule(f"{name} forward", [logits], [refs["logits_bf16"]],
                          [refs["logits_f32"]])
        emit({"phase": "pipeline", "step": f"{name} forward vs f32",
              "rows": rows})
    del logits
    old = _adapter_paths(pparams)
    adapters, base = lora.split_lora(pparams)
    _sync(dev)
    _build.reset_launches()
    t = time.perf_counter()
    loss, new = pp.pipeline_lora_step(cfg, adapters, base, tokens, mesh, m,
                                      lr=PIPELINE_LR, dtype=bf)
    loss = loss.item()
    _sync(dev)
    step_ms = (time.perf_counter() - t) * 1e3
    got_step = {k: v for k, v in _build.LAUNCHES.items() if v}
    _check_launches(f"{name} rank {rank} LoRA step", got_step, expect[1])
    held = _held_step(f"{name} rank {rank} LoRA step", loss,
                      _stage_updates(mesh, old, new, per), refs)
    emit({"phase": "pipeline", "part": name, "rank": rank, "where": where,
          "backend": "gloo", "forward_ms": fwd_ms, "step_ms": step_ms,
          "launches_forward": got, "launches_step": got_step,
          "reference_step_seconds": {k: refs[k][2] for k in ("f32",
                                                             "bf16")},
          **held})


def _pp_refs(cfg, params, tokens, dev, logits=True):
    """The world of one's plain runs on the unsharded tree: f32 and bf16
    forward logits (``logits``) and LoRA steps."""
    import torch

    from autoawq_tpu_torch.nn import modules

    refs = {}
    if logits:
        with torch.no_grad():
            for dt, key in ((torch.float32, "logits_f32"),
                            (torch.bfloat16, "logits_bf16")):
                refs[key] = modules.forward(cfg, params, tokens, "plain", dt)
    refs["f32"] = _ref_step(cfg, params, tokens, "plain", torch.float32)
    refs["bf16"] = _ref_step(cfg, params, tokens, "plain", torch.bfloat16)
    return refs


def _rank_pp_mistral(rank, dev, rng):
    """(b) Mistral-7B-Instruct-v0.2 at full width, PIPELINE_DEPTH layers,
    pipe 2 (two ranks, 4 layers a stage), unfused, rank-8 f32 adapters on
    q / k / v / o as in W, W's 4 x 512 seeded ids in 4 microbatches of 1 x
    512. A stage's forward: K2 on its 7 linears a layer and microbatch, K4
    a layer and microbatch; its step adds K10 and K11 a layer and
    microbatch."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    b, s, m = PIPELINE_W
    cfg = dataclasses.replace(ModelConfig(**MISTRAL),
                              num_hidden_layers=PIPELINE_DEPTH)
    params = _pp_adapters(cfg, _unfused(cfg, synth_zoo_params(cfg, 0, dev)),
                          ("q_proj", "k_proj", "v_proj", "o_proj"), dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    refs = _pp_refs(cfg, params, tokens, dev, logits=rank == 0)
    per = PIPELINE_DEPTH // 2
    fwd = {"w4a16_gemm": 7 * per * m, "prefill_attention": per * m}
    step = {**fwd, "prefill_attention_dkv": per * m,
            "prefill_attention_dq": per * m}
    _pp_part("pipeline (b) mistral pipe 2", rank, cfg, params, tokens,
             build_mesh(pipe=2), m, (fwd, step), refs, dev)


def _rank_pp_tp(rank, dev, rng):
    """(c) TinyLlama at full width and depth, pipe 2 x tensor 2 (four
    ranks: 11 layers a stage, 16 / 2 heads a rank), B's 2 x 384 in 2
    microbatches, adapters on q / v / o / down as in JAX's
    ``test_pipeline_tp_lora_step_matches_sequential``."""
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    b, s, m = PIPELINE_TP
    cfg = ModelConfig(**TINYLLAMA)
    params = _pp_adapters(cfg, _unfused(cfg, synth_zoo_params(cfg, 0, dev)),
                          ("q_proj", "v_proj", "o_proj", "down_proj"), dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    refs = _pp_refs(cfg, params, tokens, dev, logits=rank == 0)
    per = cfg.num_hidden_layers // 2
    fwd = {"w4a16_gemm": 7 * per * m, "prefill_attention": per * m}
    step = {**fwd, "prefill_attention_dkv": per * m,
            "prefill_attention_dq": per * m}
    _pp_part("pipeline (c) tinyllama pipe 2 x tensor 2", rank, cfg, params,
             tokens, build_mesh(pipe=2, tensor=2), m, (fwd, step), refs,
             dev)


def _stage_replay(record, mesh, layers, m, rows):
    """The f32 run's expert choice of each call a stage rank makes: its
    layers' choices for this data rank's ``rows`` tokens of each
    microbatch, in the stage's order (microbatch by microbatch)."""
    per = layers // mesh.size("pipe")
    lo = mesh.index("pipe") * per
    return [record[li][j * rows:(j + 1) * rows]
            for j in range(m) for li in range(lo, lo + per)]


def _rank_pp_breadth(rank, dev, rng):
    """(d) at full width, PIPELINE_BREADTH_DEPTH layers, four ranks:
    MPT-7B (ALiBi, 16 heads a rank) pipe 2 x tensor 2 over 2 x 256 in 2
    microbatches, then flat tensor 2 (data 2) with a 1 x 64 prefill and
    PARALLEL_DECODE_STEPS teacher-forced steps on K1; DeepSeek-V2-Lite
    (first_k_dense_replace 0: both layers MoE; MLA on 8 heads a rank, 32
    of 64 experts a rank through K6, shared experts at tp_div 2) pipe 2 x
    tensor 2, then flat tensor 2 with the absorbed decode on the rank's
    heads, the f32 run's expert choice replayed in every bf16 run. Logits
    held by the rule (rank 0), launches a rank exactly."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.api import AwqCausalLM
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.parallel import pipeline as pp
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    bf, f32 = torch.bfloat16, torch.float32
    L = PIPELINE_BREADTH_DEPTH
    b, s, m = PIPELINE_BREADTH
    steps = PARALLEL_DECODE_STEPS
    pp_mesh = build_mesh(pipe=2, tensor=2)
    flat = build_mesh(tensor=2)
    for name, hf, gs in (("mpt-7b", MPT7B, 128),
                         ("deepseek-v2-lite", DEEPSEEK_V2_LITE, MLA_MOE_GS)):
        cfg = ModelConfig.from_hf_dict(hf)
        cfg = dataclasses.replace(cfg, num_hidden_layers=L,
                                  **({"first_k_dense_replace": 0}
                                     if cfg.is_mla else {}))
        full = synth_zoo_params(cfg, 0, dev, gs)
        v = cfg.vocab_size
        tokens = torch.from_numpy(rng.integers(0, v, (b, s))).to(dev)
        prompt = torch.from_numpy(rng.integers(0, v, (1, 64))).to(dev)
        toks = torch.from_numpy(rng.integers(0, v, (steps, 1, 1))).to(dev)
        moe = cfg.is_moe
        tape = _RouteTape(L)
        rec_fwd, rec_dec = [], []
        # the unsharded plain runs: f32 (recording the expert choice on
        # every rank, which replays it) and bf16 (rank 0, replaying)
        with tape.reset(record=rec_fwd if moe else None):
            ref_fwd = {f32: modules.forward(cfg, full, tokens, "plain", f32)}
        with tape.reset(record=rec_dec if moe else None):
            ref_dec = {f32: _forced_logits(cfg, full, prompt, toks, "plain",
                                           f32, dev)[0]}
        if rank == 0:
            with tape.reset(replay=rec_fwd if moe else None):
                ref_fwd[bf] = modules.forward(cfg, full, tokens, "plain", bf)
            with tape.reset(replay=rec_dec if moe else None):
                ref_dec[bf] = _forced_logits(cfg, full, prompt, toks,
                                             "plain", bf, dev)[0]
        # pipe 2 x tensor 2: one layer a stage
        pparams = pp.to_pipeline(cfg, full, pp_mesh, device=dev)
        replay = (_stage_replay(rec_fwd, pp_mesh, L, m, b // m * s)
                  if moe else None)
        _sync(dev)
        _build.reset_launches()
        t = time.perf_counter()
        with tape.reset(replay=replay):
            logits = pp.pipeline_forward(cfg, pparams, tokens, pp_mesh, m,
                                         dtype=bf)
        _sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        got = {k: n for k, n in _build.LAUNCHES.items() if n}
        per = L // 2
        if moe:  # q, kv_a, kv_b, o and the shared experts' 3; K6 twice
            expect = {"w4a16_gemm": 7 * per * m, "moe_gemm": 2 * per * m}
        else:  # q, k, v, o, fc1, fc2; ALiBi attends in plain ops
            expect = {"w4a16_gemm": 6 * per * m}
        _check_launches(f"pipeline (d) {name} pipe 2 x tensor 2 rank {rank}",
                        got, expect)
        if rank == 0:
            rows = _hold_rule(f"pipeline (d) {name} pipe 2 x tensor 2",
                              [logits], [ref_fwd[bf]], [ref_fwd[f32]])
            emit({"phase": "pipeline", "step": f"(d) {name} pipe 2 x "
                  "tensor 2 vs f32", "rows": rows})
        emit({"phase": "pipeline", "part": f"(d) {name} pipe 2 x tensor 2",
              "rank": rank, "backend": "gloo", "forward_ms": ms,
              "launches_forward": got})
        del pparams, logits
        # flat tensor 2 (data 2): a prefill and teacher-forced decode steps
        model = AwqCausalLM(cfg, full, device=dev).shard(flat, dtype=None)
        with tape.reset(replay=rec_dec if moe else None):
            got_dec, st = _forced_logits(model.cfg, model.params, prompt,
                                         toks, "auto", bf, dev)
        if moe:  # 64 rows: q, kv_a, kv_b, o and the shared experts on K1;
            # a step: q, kv_a, o on K1 (the latent decode in plain ops),
            # the shared experts on K8
            expect = [{"w4a16_gemv": 7 * L, "moe_gemm": 2 * L},
                      {"w4a16_gemv": 3 * L, "fused_mlp3": L,
                       "moe_gemm": 2 * L}]
        else:  # q, k, v, o, fc1, fc2 on K1 (ALiBi: no K5; fc1 / fc2: no K8)
            expect = [{"w4a16_gemv": 6 * L}, {"w4a16_gemv": 6 * L}]
        _held_launches(f"pipeline (d) {name} tensor 2 rank {rank}", st,
                       expect)
        if rank == 0:
            rows = _hold_rule(f"pipeline (d) {name} tensor 2 decode",
                              got_dec, ref_dec[bf], ref_dec[f32])
            emit({"phase": "pipeline", "step": f"(d) {name} tensor 2 "
                  "decode vs f32", "rows": rows})
        emit({"phase": "pipeline", "part": f"(d) {name} tensor 2",
              "rank": rank, "backend": "gloo",
              "step_ms": [x["ms"] for x in st[1:]],
              "launches_per_step": st[1]["launches"]})
        del model, full, ref_fwd, ref_dec, got_dec
        torch.cuda.empty_cache()


def _pipeline_world_of_one(dev):
    """(a): TinyLlama at full width and depth in a world of one over NCCL:
    ``pipeline_forward`` (fused) and ``pipeline_lora_step`` (unfused,
    adapters on q / k / v / o) at pipe 1 over 4 microbatches of 1 x 384,
    beside ``forward`` and ``lora_train_step`` on the same inputs; each
    held against the plain f32 run by the teacher-forced rule (logits) or
    W's (the step), their distance from each other reported."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.parallel import distributed as pd
    from autoawq_tpu_torch.parallel import pipeline as pp
    from autoawq_tpu_torch.parallel.mesh import build_mesh
    from autoawq_tpu_torch.train import lora
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    b, s, m = PIPELINE_ONE
    bf, f32 = torch.bfloat16, torch.float32
    cfg = ModelConfig(**TINYLLAMA)
    L = cfg.num_hidden_layers
    params = synth_zoo_params(cfg, 0, dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s))).to(dev)
    pd.initialize(init_method=f"tcp://127.0.0.1:{_free_port()}",
                  world_size=1, rank=0, device=dev)
    try:
        backend = dist.get_backend()
        mesh = build_mesh()
        with torch.no_grad():
            pparams = pp.to_pipeline(cfg, params, mesh, device=dev)
            _build.reset_launches()
            t = time.perf_counter()
            got = pp.pipeline_forward(cfg, pparams, tokens, mesh, m,
                                      dtype=bf)
            _sync(dev)
            ms = (time.perf_counter() - t) * 1e3
            launches = {k: n for k, n in _build.LAUNCHES.items() if n}
            _check_launches("pipeline (a) forward", launches,
                            {"w4a16_gemm": 4 * L * m,
                             "prefill_attention": L * m})
            one = modules.forward(cfg, params, tokens, "auto", bf)
            plain = {dt: modules.forward(cfg, params, tokens, "plain", dt)
                     for dt in (bf, f32)}
        rows = _hold_rule("pipeline (a) pipeline_forward", [got],
                          [plain[bf]], [plain[f32]])
        rows += _hold_rule("pipeline (a) forward", [one], [plain[bf]],
                           [plain[f32]])
        emit({"phase": "pipeline", "part": "(a) world of one",
              "backend": backend, "forward_ms": ms,
              "launches_forward": launches, "rows": rows,
              "pipeline_vs_forward": rel_err(got, one)})
        del got, one, plain, pparams
        params = _pp_adapters(cfg, _unfused(cfg, params),
                              ("q_proj", "k_proj", "v_proj", "o_proj"), dev)
        refs = _pp_refs(cfg, params, tokens, dev, logits=False)
        kernel = _ref_step(cfg, params, tokens, "auto", bf)
        pparams = pp.to_pipeline(cfg, _fresh_adapters(params), mesh,
                                 device=dev)
        old = _adapter_paths(pparams)
        adapters, base = lora.split_lora(pparams)
        _build.reset_launches()
        t = time.perf_counter()
        loss, new = pp.pipeline_lora_step(cfg, adapters, base, tokens, mesh,
                                          m, lr=PIPELINE_LR, dtype=bf)
        loss = loss.item()
        _sync(dev)
        step_ms = (time.perf_counter() - t) * 1e3
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        _check_launches("pipeline (a) LoRA step", launches,
                        {"w4a16_gemm": 7 * L * m, "prefill_attention": L * m,
                         "prefill_attention_dkv": L * m,
                         "prefill_attention_dq": L * m})
        upd = _stage_updates(mesh, old, new, L)
        held = _held_step("pipeline (a) pipeline_lora_step", loss, upd, refs)
        held_one = _held_step("pipeline (a) lora_train_step", kernel[0],
                              {(p, (slice(None),)): u
                               for p, u in kernel[1].items()}, refs)
        dist_one = max((u - kernel[1][p][sl]).float().norm().item()
                       / max(kernel[1][p][sl].float().norm().item(), 1e-30)
                       for (p, sl), u in upd.items())
        emit({"phase": "pipeline", "part": "(a) world of one LoRA step",
              "backend": backend, "step_ms": step_ms,
              "launches_step": launches, "pipelined": held,
              "lora_train_step": held_one,
              "worst_update_vs_lora_train_step": dist_one})
    finally:
        dist.destroy_process_group()


def _pipeline_kernel_rows(dev):
    """K2 at (b)'s shapes, Mistral's unfused linears at M = 512 (a
    microbatch of 1 x 512: q / o 4096 -> 4096, k / v 4096 -> 1024, gate /
    up 4096 -> 14336, down 14336 -> 4096), and K1 at an MPT-7B rank's
    under tensor 2 (q / k / v 4096 -> 2048, o 2048 -> 4096 a row shard,
    fc1 4096 -> 8192, fc2 8192 -> 4096 a row shard), against their twins
    and timed with their bounds and library calls."""
    import numpy as np

    rng = np.random.default_rng(6)
    h, i = MISTRAL["hidden_size"], MISTRAL["intermediate_size"]
    kv = MISTRAL["num_key_value_heads"] * MISTRAL["head_dim"]
    for case, k, n in (("q / o", h, h), ("k / v", h, kv),
                       ("gate / up", h, i), ("down", i, h)):
        _gemm_case(rng, "w4a16_gemm", f"pipeline (b) mistral {case}", 512,
                   k, n, 128, True, dev)
    h = MPT7B["d_model"]
    for case, k, n in (("q / k / v", h, h // 2), ("o (row shard)", h // 2, h),
                       ("fc1", h, 2 * h), ("fc2 (row shard)", 2 * h, h)):
        _gemm_case(rng, "w4a16_gemv", f"pipeline (d) mpt-7b tensor 2 {case}",
                   1, k, n, 128, True, dev)


def phase_pipeline(dev):
    """GPipe on the card: the two ranks of (b) and the four of (c) and (d)
    spawned first, the world of one over NCCL (a) while they run, then
    their results, then the kernels at the new shapes."""
    t0 = time.perf_counter()
    worlds = [(_spawn_world(2, "pipeline", ("_rank_pp_mistral",),
                            PIPELINE_SPEC, dev), 2),
              (_spawn_world(4, "pipeline", ("_rank_pp_tp",
                                            "_rank_pp_breadth"),
                            PIPELINE_SPEC, dev), 4)]
    deadline = time.time() + PIPELINE_TIMEOUT
    try:
        _pipeline_world_of_one(dev)
    finally:
        for (ctx, tmp), n in worlds:
            _join_world(ctx, tmp, n, "pipeline", deadline)
    emit({"phase": "pipeline", "step": "ranks", "seconds":
          time.perf_counter() - t0})
    _pipeline_kernel_rows(dev)


# ------------------------------------------------------------ multimodal

def synth_vision_on_card(kind, vcfg, out_hidden, seed, dev):
    """Seeded float bf16 weights of a vision tower (and LLaVA's projector),
    drawn on the card by a torch.Generator: linears std 0.02 with biases,
    LayerNorms of ones with zero biases. ``kind`` "clip" (LLaVA's CLIP
    ViT; returns (tower, projector) to ``out_hidden``) or "qwen2_vl"
    (returns the tower, its PatchMerger ending at ``vcfg["hidden_size"]``)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf = torch.bfloat16

    def n(*shape):
        return (torch.randn(*shape, device=dev, generator=gen) * 0.02).to(bf)

    def lin(k, m):
        return {"kernel": n(k, m), "bias": n(m)}

    def ln(h):
        return {"weight": torch.ones(h, dtype=bf, device=dev),
                "bias": torch.zeros(h, dtype=bf, device=dev)}

    if kind == "clip":
        h, ps = vcfg["hidden_size"], vcfg["patch_size"]
        inter = vcfg["intermediate_size"]
        tower = {
            "class_embedding": n(h),
            "patch_embedding": {"weight": n(h, 3, ps, ps)},
            "position_embedding": {
                "weight": n((vcfg["image_size"] // ps) ** 2 + 1, h)},
            "pre_layernorm": ln(h), "post_layernorm": ln(h),
            "layers": [{"layer_norm1": ln(h), "layer_norm2": ln(h),
                        **{k: lin(h, h) for k in ("q_proj", "k_proj",
                                                  "v_proj", "out_proj")},
                        "fc1": lin(h, inter), "fc2": lin(inter, h)}
                       for _ in range(vcfg["num_hidden_layers"])]}
        return tower, {"linear_1": lin(h, out_hidden),
                       "linear_2": lin(out_hidden, out_hidden)}
    e, ps = vcfg["embed_dim"], vcfg["patch_size"]
    rows = vcfg.get("in_chans", 3) * vcfg["temporal_patch_size"] * ps * ps
    mlp = e * vcfg["mlp_ratio"]
    m = e * vcfg["spatial_merge_size"] ** 2
    return {"patch_embed": {"kernel": n(rows, e)},
            "blocks": [{"norm1": ln(e), "norm2": ln(e),
                        "qkv": lin(e, 3 * e), "proj": lin(e, e),
                        "fc1": lin(e, mlp), "fc2": lin(mlp, e)}
                       for _ in range(vcfg["depth"])],
            "merger": {"ln_q": ln(e), "mlp0": lin(m, m),
                       "mlp2": lin(m, vcfg["hidden_size"])}}


def _text_ids(gen, n, vocab, avoid):
    """``n`` seeded token ids below ``vocab``, none of them in ``avoid``."""
    import torch

    ids = torch.randint(0, vocab, (n,), device=gen.device, generator=gen)
    for a in avoid:
        ids = torch.where(ids == a, torch.zeros_like(ids), ids)
    return ids


def _embeds_twins(cfg, lm, e16, e32, seq):
    """The plain twins' forwards over a multimodal prompt (its input embeds
    in bf16 and f32) followed by the generated tokens ``seq`` [T]: [S + T,
    V] f32 logits each, row t scoring the token after t."""
    import torch

    from autoawq_tpu_torch.models.vision import lm_forward
    from autoawq_tpu_torch.nn import modules

    out = []
    for e, dt in ((e16, torch.bfloat16), (e32, torch.float32)):
        x = torch.cat([e.to(dt), modules.embed(cfg, lm, seq[None], dt)],
                      dim=1)
        out.append(lm_forward(cfg, lm, x, "plain")[0].float())
    return out


def _stream_near_tie(name, s, got, want, twins):
    """Two greedy streams of one multimodal prompt (S = ``s`` rows): equal,
    or parting first at generated token p >= 1 at a bf16 near tie of the
    f32 twin's row there (the same prefix on both): both tokens within the
    teacher-forced rule's allowance (twice the bf16 twin's distance from
    f32, plus 1e-3, of the row's scale) of the row's maximum. Returns the
    record."""
    diff = [j for j, (x, y) in enumerate(zip(got, want)) if x != y]
    check(len(got) == len(want), f"{name}: {len(got)} tokens, expected "
          f"{len(want)}")
    rec = {"equal": not diff}
    if not diff:
        return rec
    p = diff[0]
    check(p >= 1, f"{name}: the first token, from the prefill, differs")
    if p < 1:
        return rec
    b16, f32 = twins
    t = s + p - 1
    f = f32[t]
    scale = float(f.abs().max())
    allow = 2 * float((b16[t] - f).abs().max()) + 1e-3 * scale
    top = float(f.max())
    rec.update(first_difference=p, got_token=got[p], want_token=want[p],
               got_gap=top - float(f[got[p]]),
               want_gap=top - float(f[want[p]]), allowance=allow)
    check(rec["got_gap"] <= allow and rec["want_gap"] <= allow,
          f"{name}: the streams part at generated token {p} without a "
          f"bf16 near tie: {rec}")
    return rec


def _llava_traffic(dev):
    """Traffic Q (LLaVA-1.5-7B): (a) ``AwqLlavaModel.generate`` on one
    image, (b) the paged engine over four ``prompt_embeds`` requests.
    Returns (launches of the run, launches per decode step)."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.api import AwqLlavaModel
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve import paged
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    raw = LLAVA_15_7B
    vcfg = raw["vision_config"]
    cfg = ModelConfig.from_hf_dict(raw["text_config"])
    full = cfg.num_hidden_layers
    cfg = dataclasses.replace(cfg, num_hidden_layers=LLAVA_DEPTH)
    t = time.perf_counter()
    lm = synth_zoo_params(cfg, 0, dev)
    tower, proj = synth_vision_on_card("clip", vcfg, cfg.hidden_size, 1,
                                       dev)
    model = AwqLlavaModel(cfg, vcfg, raw, {"language_model": lm,
                                           "vision_tower": tower,
                                           "projector": proj}, None, dev)
    torch.cuda.synchronize()
    emit({"phase": "multimodal", "traffic": "Q", "step": "synth",
          "cut": f"language model depth {LLAVA_DEPTH} of {full} layers, "
                 "published width; the CLIP tower at full depth",
          "seconds": time.perf_counter() - t,
          "allocated_bytes": torch.cuda.memory_allocated()})
    img_tok = raw["image_token_index"]
    n_img = (vcfg["image_size"] // vcfg["patch_size"]) ** 2
    pre, post = LLAVA_PROMPT
    g = torch.Generator(device=dev)
    g.manual_seed(7)

    def prompt(head, tail):
        return torch.cat([head, torch.full((n_img,), img_tok, device=dev),
                          tail])[None]

    def text(n):
        return _text_ids(g, n, cfg.vocab_size, (img_tok,))

    head = text(pre)
    ids_a = prompt(head, text(post))
    pix = [torch.randn(1, 3, vcfg["image_size"], vcfg["image_size"],
                       device=dev, generator=g) for _ in range(3)]
    s = ids_a.shape[1]
    L, new = LLAVA_DEPTH, LLAVA_NEW

    # (a) generate on one image: K2 and K4 in the prefill, K1 and K3 a step
    t = time.perf_counter()
    e16 = model.input_embeds(ids_a, pix[0])
    torch.cuda.synchronize()
    t_vision = time.perf_counter() - t
    _build.reset_launches()
    t = time.perf_counter()
    out_a = model.generate(ids_a, pix[0], max_new_tokens=new)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    check(tuple(out_a.shape) == (1, s + new), "traffic Q output shape")
    cache = gen.init_kv_cache(cfg, 1, s + 1, torch.bfloat16, dev)
    _build.reset_launches()
    logits, _ = gen.prefill(cfg, lm, ids_a, cache, embeds=e16)
    torch.cuda.synchronize()
    per_prefill = dict(_build.LAUNCHES)
    _build.reset_launches()
    gen.decode_step(cfg, lm, logits.argmax(-1)[:, None], cache, s)
    torch.cuda.synchronize()
    per_step = dict(_build.LAUNCHES)
    del cache
    _check_launches("Q prefill", per_prefill,
                    {"w4a16_gemm": 4 * L, "prefill_attention": L,
                     "w4a16_gemv": 0, "fused_mlp": 0})
    _check_launches("Q decode step", per_step,
                    {"w4a16_gemv": 2 * L, "fused_mlp": L,
                     "fused_attn_step": 0, "w4a16_gemm": 0})
    _check_launches("Q generate", launches, {
        k: per_prefill.get(k, 0) + (new - 1) * per_step.get(k, 0)
        for k in set(per_prefill) | set(per_step)})
    e32 = model.input_embeds(ids_a, pix[0], dtype=torch.float32)
    rows = _teacher_forced(cfg, lm, ids_a, LLAVA_TF_STEPS,
                           embeds={torch.bfloat16: e16,
                                   torch.float32: e32})
    _check_teacher_forced("Q", rows)
    emit({"phase": "multimodal", "traffic": "Q", "card": card(),
          "prompt": {"text_before": pre, "image_tokens": n_img,
                     "text_after": post, "rows": s},
          "new_tokens": new, "vision_embeds_s": t_vision,
          "generate_s": t_gen, "launches": launches,
          "launches_per_prefill": per_prefill,
          "launches_per_decode_step": per_step,
          "kernel_vs_plain": rows})

    # (b) the paged engine: A and B share the image and its text prefix,
    # C has A's ids and another image, D other text and a third image
    ids = {"A": ids_a, "B": prompt(head, text(post)),
           "C": ids_a, "D": prompt(text(pre), text(post))}
    imgs = {"A": pix[0], "B": pix[0], "C": pix[1], "D": pix[2]}
    emb = {r: model.input_embeds(ids[r], imgs[r]) for r in ids}
    ps = PAGED_POOL["page_size"]
    pool = dict(PAGED_POOL, pages_per_seq=-(-(s + new + 1) // ps))
    eng = paged.PagedBatchingEngine(cfg, lm, **pool)
    for r in ids:
        eng.add_request(r, ids[r][0].cpu().numpy(), new,
                        prompt_embeds=emb[r][0])
    _build.reset_launches()
    eng.step()  # every admission, and the first decode step
    torch.cuda.synchronize()
    engine_launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    eng.step()
    torch.cuda.synchronize()
    paged_step = dict(_build.LAUNCHES)
    _build.reset_launches()
    streams = eng.run()
    torch.cuda.synchronize()
    for part in (paged_step, _build.LAUNCHES):
        for k, n in part.items():
            engine_launches[k] = engine_launches.get(k, 0) + n
    _check_launches("Q paged step", paged_step,
                    {"paged_attn": L, "w4a16_gemv": 2 * L, "fused_mlp": L,
                     "paged_attn_stock": 0, "fused_attn_step": 0})
    shared = min((pre + n_img) // ps, (s - 1) // ps)
    check((eng.prefix_hits, eng.prefix_pages_reused) == (1, shared),
          f"traffic Q paged: prefix hits {eng.prefix_hits}, pages reused "
          f"{eng.prefix_pages_reused}; expected 1 and {shared}")
    recs = {}
    for r in ids:
        want = (out_a if r == "A" else model.generate(
            ids[r], imgs[r], max_new_tokens=new))[0, s:].tolist()
        got = [int(x) for x in streams[r]]
        twins = None
        if got != want:
            twins = _embeds_twins(
                cfg, lm, emb[r],
                model.input_embeds(ids[r], imgs[r], dtype=torch.float32),
                torch.tensor(got[:-1], device=dev))
        recs[r] = _stream_near_tie(f"traffic Q paged {r}", s, got, want,
                                   twins)
    emit({"phase": "multimodal", "traffic": "Q paged", "pool": pool,
          "prefix_hits": eng.prefix_hits,
          "prefix_pages_reused": eng.prefix_pages_reused,
          "launches": engine_launches, "launches_per_step": paged_step,
          "vs_generate": recs})
    del eng, model, lm, tower, proj
    torch.cuda.empty_cache()
    total = {k: launches.get(k, 0) + engine_launches.get(k, 0)
             for k in set(launches) | set(engine_launches)}
    return total, {"Q": per_step, "Q paged": paged_step}


def _qwen_vl_prompt(gen, raw, vcfg, grid, dev):
    """One Qwen2-VL prompt: text, <|vision_start|>, the image's
    placeholders (t * h * w / merge^2), <|vision_end|>, text; and its
    seeded patch rows [t * h * w, C * tps * ps * ps]."""
    import torch

    t, h, w = grid
    n = t * h * w // vcfg["spatial_merge_size"] ** 2
    pre, post = QWEN_VL_TEXT
    special = (raw["image_token_id"], raw["video_token_id"],
               raw["vision_start_token_id"], raw["vision_start_token_id"] + 1)
    ids = torch.cat([
        _text_ids(gen, pre, raw["vocab_size"], special),
        torch.tensor([special[2]], device=dev),
        torch.full((n,), raw["image_token_id"], device=dev),
        torch.tensor([special[3]], device=dev),
        _text_ids(gen, post, raw["vocab_size"], special)])
    rows = 3 * vcfg["temporal_patch_size"] * vcfg["patch_size"] ** 2
    patches = torch.randn(t * h * w, rows, device=dev, generator=gen)
    return ids.cpu().numpy()[None], patches


def _kl_mean(ref, test):
    """Mean over rows of KL(softmax(ref) || softmax(test))."""
    import torch

    pr = torch.log_softmax(ref.float(), -1)
    pt = torch.log_softmax(test.float(), -1)
    return float((torch.exp(pr) * (pr - pt)).sum(-1).mean())


def _qwen_vl_traffic(dev):
    """Traffic Z (Qwen2-VL-7B-Instruct): (a) ``AwqQwen2VLModel.__call__``
    on one image against the plain path, (b) image-conditioned AWQ of one
    layer with its KL gate and a save / reload round trip. Returns the
    launches of (a)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from autoawq_tpu_torch.api import AwqQwen2VLModel
    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.models.qwen_vl import multimodal_calib_inputs
    from autoawq_tpu_torch.models.vision import lm_forward
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    raw = QWEN2_VL_7B
    vcfg = dict(raw["vision_config"])
    vcfg.setdefault("in_channels", vcfg.get("in_chans", 3))
    cfg = ModelConfig.from_hf_dict(raw)
    full = cfg.num_hidden_layers
    cfg = dataclasses.replace(cfg, num_hidden_layers=QWEN_VL_DEPTH)
    hd, nh, nkv = (cfg.head_dim_, cfg.num_attention_heads,
                   cfg.num_key_value_heads)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    t = time.perf_counter()
    lm = synth_zoo_params(cfg, 0, dev)
    for lp in lm["layers"]:  # Qwen2's q / k / v bias
        lp["self_attn"]["qkv_proj"]["bias"] = (torch.randn(
            (nh + 2 * nkv) * hd, device=dev, generator=g) * 0.02).to(
                torch.bfloat16)
    tower = synth_vision_on_card("qwen2_vl", vcfg, cfg.hidden_size, 2, dev)
    model = AwqQwen2VLModel(cfg, vcfg, raw, {"visual": tower,
                                             "language_model": lm}, None,
                            dev)
    torch.cuda.synchronize()
    emit({"phase": "multimodal", "traffic": "Z", "step": "synth",
          "cut": f"language model depth {QWEN_VL_DEPTH} of {full} layers, "
                 "published width; the vision tower at full depth",
          "seconds": time.perf_counter() - t,
          "allocated_bytes": torch.cuda.memory_allocated()})
    grid = QWEN_VL_GRID
    ids, patches = _qwen_vl_prompt(g, raw, vcfg, grid, dev)
    s = ids.shape[1]

    # (a) the forward: K2 takes every linear of the language model
    model(ids, patches, [grid])
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    got = model(ids, patches, [grid])
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    m_lin = "w4a16_gemm" if s >= 256 else "w4a16_gemv"
    _check_launches("Z", launches, {m_lin: 4 * QWEN_VL_DEPTH,
                                    "prefill_attention": 0})
    plain = model(ids, patches, [grid], method="plain")
    f32 = model(ids, patches, [grid], method="plain", dtype=torch.float32)
    check(tuple(got.shape) == (1, s, cfg.vocab_size), "traffic Z shape")
    scale = f32[0].abs().amax(-1).clamp_min(1e-30)
    k_rel = ((got[0] - f32[0]).abs().amax(-1) / scale).tolist()
    p_rel = ((plain[0] - f32[0]).abs().amax(-1) / scale).tolist()
    rows = [{"position": i, "kernel_vs_f32": a, "plain_bf16_vs_f32": b}
            for i, (a, b) in enumerate(zip(k_rel, p_rel))]
    _check_teacher_forced("Z", rows)
    emit({"phase": "multimodal", "traffic": "Z", "card": card(),
          "grid_thw": list(grid), "rows": s, "forward_s": t_fwd,
          "launches": launches,
          "max_kernel_vs_f32": max(k_rel), "max_plain_bf16_vs_f32":
          max(p_rel)})
    del lm, got, plain, f32
    model.params["language_model"] = None
    torch.cuda.empty_cache()

    # (b) image-conditioned AWQ of QWEN_VL_QUANT_LAYERS layers
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=QWEN_VL_QUANT_LAYERS)
    fp = _outlier_fp(cfg1, dev)
    for lp in fp["layers"]:
        for n, heads in (("q", nh), ("k", nkv), ("v", nkv)):
            lp["self_attn"][f"{n}_proj"]["bias"] = torch.randn(
                heads * hd, device=dev, generator=g) * 0.02
    n_cal = QWEN_VL_CALIB
    cal = [_qwen_vl_prompt(g, raw, vcfg, grid, dev) for _ in range(n_cal)]
    held = [_qwen_vl_prompt(g, raw, vcfg, grid, dev) for _ in range(2)]
    qm = AwqQwen2VLModel(cfg1, vcfg, raw, {"visual": tower,
                                           "language_model": fp}, None, dev)
    qcfg = AwqConfig(w_bit=4, q_group_size=128, zero_point=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    qm.quantize(quant_config=qcfg,
                calib_data=np.concatenate([c[0] for c in cal]),
                calib_patches=torch.cat([c[1] for c in cal]),
                calib_grid_thw=[grid] * n_cal, progress=False)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    awq = qm.params["language_model"]
    check(all("qweight" in lp["self_attn"]["q_proj"] for lp in awq["layers"]),
          "traffic Z: the language model is not packed")
    hx, hc, hs = multimodal_calib_inputs(
        cfg1, vcfg, {"visual": tower, "language_model": fp},
        np.concatenate([h[0] for h in held]),
        torch.cat([h[1] for h in held]), [grid] * 2,
        image_token_id=raw["image_token_id"],
        video_token_id=raw["video_token_id"])
    ref = lm_forward(cfg1, fp, hx, "plain", hc, hs)
    kl = {name: _kl_mean(ref, lm_forward(cfg1, tree, hx, "plain", hc, hs))
          for name, tree in (("awq", awq), ("rtn", _rtn(cfg1, fp, qcfg)))}
    check(kl["awq"] <= kl["rtn"], f"traffic Z: AWQ's mean KL "
          f"{kl['awq']:.4g} on held-out image prompts is above RTN's "
          f"{kl['rtn']:.4g}")
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        qm.save_quantized(d)
        back = AwqQwen2VLModel.from_quantized(d, device=dev)
        t_io = time.perf_counter() - t
        keys = _saved_keys(d)
    check(any(k.startswith("model.visual.") for k in keys)
          and "model.language_model.layers.0.self_attn.q_proj.qweight"
          in keys, "traffic Z: the saved checkpoint lacks its tower or "
          "its packed language model")
    qm.params = _f16_rounded(qm.params)
    mem = qm(held[0][0], held[0][1], [grid])
    rel = rel_err(back(held[0][0], held[0][1], [grid]), mem)[1]
    check(rel <= 1e-5, f"traffic Z: reloaded logits {rel:.3g} from the "
          "in-memory model's")
    q = qm._quantizer
    emit({"phase": "multimodal", "traffic": "Z awq", "card": card(),
          "layers": f"{QWEN_VL_QUANT_LAYERS} of {full}, published width",
          "calib": [n_cal, s], "quantize_s": t_quant,
          "seconds_by_part": _quant_timings(q, t_quant),
          "peak_memory_bytes": peak, "kl_held_out": kl,
          "layer0_ratio_index": _ratio_indices(q), "save_load_s": t_io,
          "reload_vs_memory_rel": rel})
    del qm, back, fp, awq, tower, model
    torch.cuda.empty_cache()
    return launches


def _f16_rounded(tree):
    """Float leaves rounded through f16 in their own dtype, as a save
    writes them (the int4 scales are f16 in the files too)."""
    import torch

    if isinstance(tree, dict):
        return {k: _f16_rounded(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f16_rounded(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.half().to(tree.dtype)
    return tree


def _multimodal_kernel_rows(dev):
    """K2 at LLaVA's (M = 600) and Qwen2-VL's (M = Z's rows) linears, K4
    at LLaVA's prefill, K1 and K3 at Llama-2-7B's decode, each against its
    twin and timed with its bound and library call."""
    import numpy as np
    import torch

    from autoawq_tpu_torch.models.config import ModelConfig

    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(5)
    rng = np.random.default_rng(5)
    llama = ModelConfig.from_hf_dict(LLAVA_15_7B["text_config"])
    qwen = ModelConfig.from_hf_dict(QWEN2_VL_7B)
    vcfg = LLAVA_15_7B["vision_config"]
    m_q = (sum(LLAVA_PROMPT)
           + (vcfg["image_size"] // vcfg["patch_size"]) ** 2)
    t, h, w = QWEN_VL_GRID
    m_z = (sum(QWEN_VL_TEXT) + 2 + t * h * w
           // QWEN2_VL_7B["vision_config"]["spatial_merge_size"] ** 2)
    rows = []

    def linears(c):
        hd, nh, nkv = (c.head_dim_, c.num_attention_heads,
                       c.num_key_value_heads)
        hs, inter = c.hidden_size, c.intermediate_size
        return {"qkv": (hs, (nh + 2 * nkv) * hd), "o": (nh * hd, hs),
                "gate_up": (hs, 2 * inter), "down": (inter, hs)}

    for name, c, m in (("LLaVA-1.5-7B", llama, m_q),
                       ("Qwen2-VL-7B", qwen, m_z)):
        for lin, (k, n) in linears(c).items():
            rows.append(_gemm_case(rng, "w4a16_gemm", f"{name} {lin}", m, k,
                                   n, 128, True, dev, gen=gen_t))
    rows.append(_attn_case(1, m_q, llama.num_attention_heads,
                           llama.num_key_value_heads, llama.head_dim_, dev,
                           case="LLaVA-1.5-7B prefill"))
    for lin in ("qkv", "o"):
        k, n = linears(llama)[lin]
        rows.append(_gemm_case(rng, "w4a16_gemv", f"LLaVA-1.5-7B {lin}", 1,
                               k, n, 128, True, dev, gen=gen_t))
    rows.append(_mlp_case(rng, 1, "silu", dev, h=llama.hidden_size,
                          inter=llama.intermediate_size,
                          case="LLaVA-1.5-7B", gen=gen_t))
    return rows


def phase_multimodal(dev):
    """Vision-language models on the card: traffic Q (LLaVA-1.5-7B), then
    traffic Z (Qwen2-VL-7B-Instruct), then the kernel rows at their
    shapes. Returns (launches of the main path's runs, launches per decode
    step, kernel rows)."""
    import torch

    t = time.perf_counter()
    counts_q, per_step = _llava_traffic(dev)
    t_q = time.perf_counter() - t
    counts_z = _qwen_vl_traffic(dev)
    t_z = time.perf_counter() - t - t_q
    rows = _multimodal_kernel_rows(dev)
    emit({"phase": "multimodal", "step": "seconds_by_part",
          "Q": t_q, "Z": t_z,
          "kernel_rows": time.perf_counter() - t - t_q - t_z})
    torch.cuda.empty_cache()
    total = {k: counts_q.get(k, 0) + counts_z.get(k, 0)
             for k in set(counts_q) | set(counts_z)}
    for name in ("w4a16_gemv", "w4a16_gemm", "fused_mlp",
                 "prefill_attention", "paged_attn"):
        check(total.get(name, 0) > 0, f"multimodal: {name} never launched")
    return total, per_step, rows


def _omni_keys(part, c):
    """HF names and shapes of a float part of Qwen2.5-Omni (``part``
    "audio", "talker", "dit" or "bigvgan", ``c`` its config dict) ->
    {name: (shape, init)}; init "n" std 0.02, "w" std 1 / sqrt(fan-in),
    "e" std 1 (an embedding table), "1" ones, "0" zeros."""
    k = {}
    if part == "audio":
        d, f = c["d_model"], c["encoder_ffn_dim"]
        k.update({"conv1.weight": ((d, c["num_mel_bins"], 3), "n"),
                  "conv1.bias": ((d,), "n"),
                  "conv2.weight": ((d, d, 3), "n"), "conv2.bias": ((d,), "n"),
                  "ln_post.weight": ((d,), "1"), "ln_post.bias": ((d,), "0"),
                  "proj.weight": ((c["output_dim"], d), "n"),
                  "proj.bias": ((c["output_dim"],), "n")})
        for i in range(c["encoder_layers"]):
            p = f"layers.{i}."
            for n in ("q", "k", "v", "out"):
                k[p + f"self_attn.{n}_proj.weight"] = ((d, d), "n")
                if n != "k":  # Whisper: k has no bias
                    k[p + f"self_attn.{n}_proj.bias"] = ((d,), "n")
            for n in ("self_attn_layer_norm", "final_layer_norm"):
                k[p + n + ".weight"], k[p + n + ".bias"] = ((d,), "1"), \
                    ((d,), "0")
            k.update({p + "fc1.weight": ((f, d), "n"), p + "fc1.bias": ((f,), "n"),
                      p + "fc2.weight": ((d, f), "n"), p + "fc2.bias": ((d,), "n")})
    elif part == "talker":
        h, e, v = c["hidden_size"], c["embedding_size"], c["vocab_size"]
        hd, nh, nkv = c["head_dim"], c["num_attention_heads"], \
            c["num_key_value_heads"]
        inter = c["intermediate_size"]
        k.update({"model.embed_tokens.weight": ((v, e), "n"),
                  "thinker_to_talker_proj.weight": ((h, e), "n"),
                  "thinker_to_talker_proj.bias": ((h,), "n"),
                  "model.norm.weight": ((h,), "1"),
                  "codec_head.weight": ((v, h), "n")})
        for i in range(c["num_hidden_layers"]):
            p = f"model.layers.{i}."
            for n, rows in (("q", nh * hd), ("k", nkv * hd), ("v", nkv * hd)):
                k[p + f"self_attn.{n}_proj.weight"] = ((rows, h), "n")
                k[p + f"self_attn.{n}_proj.bias"] = ((rows,), "n")
            k[p + "self_attn.o_proj.weight"] = ((h, nh * hd), "n")
            for n in ("gate", "up"):
                k[p + f"mlp.{n}_proj.weight"] = ((inter, h), "n")
            k[p + "mlp.down_proj.weight"] = ((h, inter), "n")
            k[p + "input_layernorm.weight"] = ((h,), "1")
            k[p + "post_attention_layernorm.weight"] = ((h,), "1")
    elif part == "dit":
        h, mel = c["hidden_size"], c["mel_dim"]
        ch, ks = c["enc_channels"], c["enc_kernel_sizes"]
        sc, att = c["enc_res2net_scale"], c["enc_attention_channels"]

        def lin(name, o, i, init="w"):
            k[name + ".weight"] = ((o, i), init)
            k[name + ".bias"] = ((o,), "0")

        def conv(name, o, i, kk):
            k[name + ".weight"] = ((o, i, kk), "w")
            k[name + ".bias"] = ((o,), "0")
        lin("time_embed.time_mlp.0", h, 256)
        lin("time_embed.time_mlp.2", h, h)
        k["text_embed.codec_embed.weight"] = ((c["num_embeds"] + 1,
                                               c["emb_dim"]), "e")
        lin("input_embed.proj", h, mel + c["enc_dim"] + c["emb_dim"]
            + c["enc_emb_dim"])
        pre = "input_embed.spk_encoder."
        conv(pre + "blocks.0.conv", ch[0], mel, ks[0])
        for i in range(1, len(ch) - 1):
            b = f"{pre}blocks.{i}."
            conv(b + "tdnn1.conv", ch[i], ch[i - 1], 1)
            for j in range(sc - 1):
                conv(b + f"res2net_block.blocks.{j}.conv", ch[i] // sc,
                     ch[i] // sc, ks[i])
            conv(b + "tdnn2.conv", ch[i], ch[i], 1)
            conv(b + "se_block.conv1", c["enc_se_channels"], ch[i], 1)
            conv(b + "se_block.conv2", ch[i], c["enc_se_channels"], 1)
        conv(pre + "mfa.conv", ch[-1], sum(ch[1:-1]), ks[-1])
        conv(pre + "asp.tdnn.conv", att, 3 * ch[-1], 1)
        conv(pre + "asp.conv", ch[-1], att, 1)
        conv(pre + "fc", c["enc_dim"], 2 * ch[-1], 1)
        for i in range(c["num_hidden_layers"]):
            p = f"transformer_blocks.{i}."
            lin(p + "attn_norm.linear", 6 * h, h)
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                lin(p + "attn." + n, h, h)
            lin(p + "ff.ff.0", h * c["ff_mult"], h)
            lin(p + "ff.ff.3", h, h * c["ff_mult"])
        lin("norm_out.linear", 2 * h, h)
        lin("proj_out", mel, h)
    else:  # bigvgan
        c0 = c["upsample_initial_channel"]
        k["conv_pre.weight"] = ((c0, c["mel_dim"], 7), "w")
        k["conv_pre.bias"] = ((c0,), "0")
        n_res = len(c["resblock_kernel_sizes"])
        for li, kk in enumerate(c["upsample_kernel_sizes"]):
            ci = c0 // 2 ** li
            k[f"ups.{li}.0.weight"] = ((ci, ci // 2, kk), "w")
            k[f"ups.{li}.0.bias"] = ((ci // 2,), "0")
            for bi, (rk, dil) in enumerate(zip(c["resblock_kernel_sizes"],
                                               c["resblock_dilation_sizes"])):
                p = f"resblocks.{li * n_res + bi}."
                for j in range(len(dil)):
                    for cv in ("convs1", "convs2"):
                        k[p + f"{cv}.{j}.weight"] = ((ci // 2, ci // 2, rk),
                                                     "w")
                        k[p + f"{cv}.{j}.bias"] = ((ci // 2,), "0")
                for a in range(2 * len(dil)):
                    for n in ("alpha", "beta"):
                        k[p + f"activations.{a}.act.{n}"] = ((ci // 2,), "0")
        c_last = c0 // 2 ** len(c["upsample_rates"])
        for n in ("alpha", "beta"):
            k[f"activation_post.act.{n}"] = ((c_last,), "0")
        k["conv_post.weight"] = ((1, c_last, 7), "w")
    return k


def synth_omni_on_card(raw, seed, dev):
    """Seeded float weights of Qwen2.5-Omni's parts that ride ``_extra``,
    under the names a full omni checkpoint's load gives them: the audio
    tower (``audio_tower.*``, f32, the dtype JAX's tower computes in), the
    talker (``talker.*``, bf16) and token2wav's DiT and BigVGAN
    (``token2wav.code2wav_dit_model.*`` / ``...bigvgan_model.*``, f32),
    drawn on the card by a torch.Generator (``_omni_keys``' inits)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t2w = raw["token2wav_config"]
    parts = (("audio", raw["thinker_config"]["audio_config"], "audio_tower.",
              torch.float32),
             ("talker", raw["talker_config"], "talker.", torch.bfloat16),
             ("dit", t2w["dit_config"], "token2wav.code2wav_dit_model.",
              torch.float32),
             ("bigvgan", t2w["bigvgan_config"],
              "token2wav.code2wav_bigvgan_model.", torch.float32))
    extra = {}
    for part, c, prefix, dt in parts:
        for name, (shape, init) in _omni_keys(part, c).items():
            if init in "10":
                t = (torch.ones if init == "1" else torch.zeros)(
                    shape, dtype=dt, device=dev)
            else:
                std = {"n": 0.02, "e": 1.0}.get(
                    init, 1.0 / math.sqrt(math.prod(shape[1:])))
                t = (torch.randn(shape, device=dev, generator=gen)
                     * std).to(dt)
            extra[prefix + name] = t
    return extra


def _talker_teacher_forced(talker, talker32, embeds, reply, codes, steps):
    """The talker's prefill and ``steps`` decode steps fed ``codes`` (the
    kernel run's own stream) on the kernel path (bf16), the plain twins
    (bf16) and the plain twins in f32 (the same weights cast): each row's
    distance from f32, as ``_teacher_forced``."""
    import torch

    from autoawq_tpu_torch.serve import generate as gen

    b, s, _ = embeds.shape
    dev = embeds.device
    runs = {"kernel": (talker, "auto", torch.bfloat16),
            "plain": (talker, "plain", torch.bfloat16),
            "plain_f32": (talker32, "plain", torch.float32)}
    caches = {k: gen.init_kv_cache(t.cfg, b, s + steps + 1, dt, dev)
              for k, (t, _, dt) in runs.items()}
    zeros = torch.zeros((b, s), dtype=torch.long, device=dev)
    lm_in = talker.project(embeds)
    logits = {k: gen.prefill(t.cfg, t.params, zeros, caches[k], m, dt,
                             embeds=lm_in.to(dt))[0]
              for k, (t, m, dt) in runs.items()}
    table, rep = talker.embed_tokens.float(), reply.float()
    rows = []
    for i in range(steps + 1):
        ref = logits["plain_f32"]
        rows.append({"position": s + i - 1,
                     "kernel_vs_f32": rel_err(logits["kernel"], ref)[1],
                     "plain_bf16_vs_f32": rel_err(logits["plain"], ref)[1],
                     "argmax_agree_f32": float(
                         (logits["kernel"].argmax(-1) == ref.argmax(-1))
                         .float().mean())})
        if i == steps:
            break
        tok = codes[:, i]
        e = talker.project((table[tok] + rep[:, min(i, rep.shape[1] - 1)])
                           [:, None])
        logits = {k: gen.decode_step(t.cfg, t.params, tok[:, None],
                                     caches[k], s + i, m, dt,
                                     embeds=e.to(dt))[0]
                  for k, (t, m, dt) in runs.items()}
    return rows


def _to_cpu(tree):
    return {k: v.cpu() for k, v in tree.items()}


def phase_omni(dev):
    """Traffic AU, Qwen2.5-Omni-7B's speech path on the card: (a) the audio
    tower on 10 s of mel, the thinker's audio prompt through ``generate``;
    (b) the talker's codec tokens from the thinker's embeds; (c)
    token2wav's mel and waveform. Returns (launches of the run, launches
    per decode step)."""
    import dataclasses

    import torch

    from autoawq_tpu_torch.models import token2wav as t2w
    from autoawq_tpu_torch.models.audio import (audio_encoder,
                                                extra_audio_weights)
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.models.talker import OmniTalker
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    raw = QWEN25_OMNI_7B
    acfg = raw["thinker_config"]["audio_config"]
    tcfg = raw["talker_config"]
    dcfg = raw["token2wav_config"]["dit_config"]
    bcfg = raw["token2wav_config"]["bigvgan_config"]
    bf, f32 = torch.bfloat16, torch.float32
    cfg = ModelConfig.from_hf_dict(raw)
    full = cfg.num_hidden_layers
    cfg = dataclasses.replace(cfg, num_hidden_layers=OMNI_DEPTH)
    L = OMNI_DEPTH
    hd, nh, nkv = (cfg.head_dim_, cfg.num_attention_heads,
                   cfg.num_key_value_heads)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    lm = synth_zoo_params(cfg, 0, dev)
    for lp in lm["layers"]:  # Qwen2's q / k / v bias
        lp["self_attn"]["qkv_proj"]["bias"] = (torch.randn(
            (nh + 2 * nkv) * hd, device=dev, generator=g) * 0.02).to(bf)
    extra = synth_omni_on_card(raw, 3, dev)
    torch.cuda.synchronize()
    emit({"phase": "omni", "traffic": "AU", "step": "synth",
          "cut": f"thinker depth {L} of {full} layers, published width; "
                 "the audio tower, talker, DiT and BigVGAN at full depth",
          "seconds": time.perf_counter() - t0,
          "allocated_bytes": torch.cuda.memory_allocated()})

    # (a) the audio prompt through the thinker: K2 in the prefill, K1 and
    # K3 a decode step; K4 only where the config carries no window
    t_a = time.perf_counter()
    mel = torch.randn(acfg["num_mel_bins"], OMNI_MEL, device=dev,
                      generator=g)
    audio_encoder(acfg, extra_audio_weights({"_extra": extra}), mel[:, :200],
                  200, device=dev)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    audio = audio_encoder(acfg, extra_audio_weights({"_extra": extra}), mel,
                          OMNI_MEL, device=dev)
    torch.cuda.synchronize()
    t_tower = time.perf_counter() - t
    n2 = 2 * acfg["n_window"]
    n_audio = (OMNI_MEL // n2) * (n2 // 2) // 2
    check(tuple(audio.shape) == (n_audio, acfg["output_dim"])
          and audio.dtype == f32 and bool(torch.isfinite(audio).all()),
          f"traffic AU: audio embeds {tuple(audio.shape)} {audio.dtype}, "
          f"expected ({n_audio}, {acfg['output_dim']}) f32, finite")
    tok_a = raw["thinker_config"]["audio_token_index"]
    pre, post = OMNI_TEXT
    ids = torch.cat([_text_ids(g, pre, cfg.vocab_size, (tok_a,)),
                     torch.full((n_audio,), tok_a, device=dev),
                     _text_ids(g, post, cfg.vocab_size, (tok_a,))])[None]
    s = ids.shape[1]

    def embeds(dt):
        e = modules.embed(cfg, lm, ids, dt)
        e[:, pre:pre + n_audio] = audio.to(dt)
        return e
    e16, e32 = embeds(bf), embeds(f32)
    gen.generate(cfg, lm, ids, 2, prompt_embeds=e16)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    out = gen.generate(cfg, lm, ids, OMNI_NEW, prompt_embeds=e16)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    check(tuple(out.shape) == (1, s + OMNI_NEW), "traffic AU output shape")
    cache = gen.init_kv_cache(cfg, 1, s + 1, bf, dev)
    _build.reset_launches()
    logits, _ = gen.prefill(cfg, lm, ids, cache, embeds=e16)
    torch.cuda.synchronize()
    per_prefill = dict(_build.LAUNCHES)
    _build.reset_launches()
    gen.decode_step(cfg, lm, logits.argmax(-1)[:, None], cache, s)
    torch.cuda.synchronize()
    per_step = dict(_build.LAUNCHES)
    del cache
    windowed = not modules.causal_prefill_ok(cfg)
    _check_launches("AU prefill", per_prefill,
                    {"w4a16_gemm": 4 * L,
                     "prefill_attention": 0 if windowed else L,
                     "w4a16_gemv": 0, "fused_mlp": 0})
    _check_launches("AU decode step", per_step,
                    {"w4a16_gemv": 2 * L, "fused_mlp": L,
                     "fused_attn_step": 0, "w4a16_gemm": 0,
                     "prefill_attention": 0})
    _check_launches("AU generate", launches, {
        k: per_prefill.get(k, 0) + (OMNI_NEW - 1) * per_step.get(k, 0)
        for k in set(per_prefill) | set(per_step)})
    rows = _teacher_forced(cfg, lm, ids, OMNI_TF_STEPS,
                           embeds={bf: e16, f32: e32})
    _check_teacher_forced("AU", rows)
    cache = gen.init_kv_cache(cfg, 1, s + 9, bf, dev)
    logits, _ = gen.prefill(cfg, lm, ids, cache, embeds=e16)
    tok = [logits.argmax(-1)[:, None]]

    def step(i):
        lg, _ = gen.decode_step(cfg, lm, tok[0], cache, s + i)
        tok[0] = lg.argmax(-1)[:, None]
    prof = device_profile(step, 8, match=("DenseJob", "ActOut", "DownJob"))
    del cache
    t_a = time.perf_counter() - t_a
    emit({"phase": "omni", "traffic": "AU (a) audio prompt", "card": card(),
          "mel_frames": OMNI_MEL, "audio_embeds": n_audio,
          "prompt": {"text_before": pre, "audio": n_audio,
                     "text_after": post, "rows": s},
          "k4_case": ("the config's window (sliding_window 32768, "
                      "use_sliding_window false) is read as a window: the "
                      "prompt attends in plain ops, K4 0") if windowed
          else "no window: K4 a layer",
          "tower_s": t_tower, "generate_s": t_gen, "new_tokens": OMNI_NEW,
          "launches": launches, "launches_per_prefill": per_prefill,
          "launches_per_decode_step": per_step, "kernel_vs_plain": rows,
          "decode_profile": prof})

    # (b) the talker: the thinker's prompt embeds and its reply's, 64 codec
    # tokens in bf16; K4 in the prefill, one a layer, and nothing else
    t_b = time.perf_counter()
    talker = OmniTalker(tcfg, extra, device=dev)
    reply = modules.embed(cfg, lm, out[:, s:], bf)
    talker.generate_codec(e16, reply, 2, dtype=bf)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    codes = talker.generate_codec(e16, reply, OMNI_CODES, dtype=bf)
    torch.cuda.synchronize()
    t_talker = time.perf_counter() - t
    talker_launches = dict(_build.LAUNCHES)
    n_layers = tcfg["num_hidden_layers"]
    _check_launches("AU talker", talker_launches,
                    {"prefill_attention": n_layers, "w4a16_gemv": 0,
                     "w4a16_gemm": 0, "fused_mlp": 0, "fused_attn_step": 0})
    check(tuple(codes.shape) == (1, OMNI_CODES)
          and bool(((codes >= 0) & (codes < tcfg["vocab_size"])).all()),
          f"traffic AU: codec tokens {tuple(codes.shape)} outside "
          f"[0, {tcfg['vocab_size']})")
    talker32 = OmniTalker(tcfg, extra, device=dev, dtype=f32)
    rows_t = _talker_teacher_forced(talker, talker32, e16, reply, codes,
                                    OMNI_TALKER_TF)
    _check_teacher_forced("AU talker", rows_t)
    del talker32
    torch.cuda.empty_cache()
    t_b = time.perf_counter() - t_b
    emit({"phase": "omni", "traffic": "AU (b) talker", "card": card(),
          "prompt_rows": s, "reply_rows": OMNI_NEW, "codes": OMNI_CODES,
          "generate_codec_s": t_talker, "launches": talker_launches,
          "kernel_vs_plain": rows_t})

    # (c) token2wav in f32: the talker's codes as they are (those past the
    # DiT's table, the talker's special tokens, read its last row, as JAX's
    # gather clamps them), a seeded reference mel, speaker embedding and
    # noise
    t_c = time.perf_counter()
    code = codes
    cond = torch.randn(1, dcfg["enc_emb_dim"], device=dev, generator=g)
    ref_mel = torch.randn(1, OMNI_REF_FRAMES, dcfg["mel_dim"], device=dev,
                          generator=g)
    frames = OMNI_CODES * dcfg["repeats"]
    noise = torch.randn(1, frames, dcfg["mel_dim"], device=dev, generator=g)
    t = time.perf_counter()
    wav = t2w.token2wav(extra, dcfg, bcfg, code, cond, ref_mel, noise,
                        device=dev, **OMNI_T2W)
    torch.cuda.synchronize()
    t_wav = time.perf_counter() - t
    samples = frames * math.prod(bcfg["upsample_rates"])
    check(tuple(wav.shape) == (1, samples) and bool(torch.isfinite(wav).all())
          and float(wav.abs().max()) <= 1.0,
          f"traffic AU: waveform {tuple(wav.shape)}, expected (1, "
          f"{samples}) finite in [-1, 1]")
    dit_w = t2w.token2wav_weights(extra, "code2wav_dit_model")
    bv_w = t2w.token2wav_weights(extra, "code2wav_bigvgan_model")
    t = time.perf_counter()
    mel_out = t2w.dit_sample(dit_w, dcfg, cond, ref_mel, code, noise,
                             device=dev, **OMNI_T2W)
    torch.cuda.synchronize()
    t_mel = time.perf_counter() - t
    check(tuple(mel_out.shape) == (1, dcfg["mel_dim"], frames)
          and bool(torch.isfinite(mel_out).all()),
          f"traffic AU: mel {tuple(mel_out.shape)}")
    # against the CPU: the first RK4 evaluation's DiT forward (CFG) on the
    # first codes and the vocoder on the first frames of the card's mel,
    # each against an f64 run on the CPU: the card's f32 within
    # ``OMNI_F64_RULE`` times the CPU's f32 distance from it (+1e-6 of the
    # scale). A control runs the vocoder on the card with TF32 on (the
    # scope bypassed).
    n = OMNI_DIT_CHECK
    spk = cond[:, None].expand(-1, n * dcfg["repeats"], -1)
    dit_args = (noise[:, :n * dcfg["repeats"]], ref_mel, spk, code[:, :n])
    cut = mel_out[..., :OMNI_VOCODER_CHECK]
    held = {}
    for name, fn, w, c, args in (
            ("dit_forward", t2w.dit_forward, dit_w, dcfg,
             dit_args + (0.0,)),
            ("vocoder", t2w.bigvgan_forward, bv_w, bcfg, (cut,))):
        cpu_w = _to_cpu(w)
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
        got = fn(w, c, *args, device=dev).cpu()
        c32 = fn(cpu_w, c, *cpu_args, device="cpu")
        c64 = fn(cpu_w, c, *cpu_args, device="cpu", dtype=torch.float64)
        held[name] = {"card_vs_f64": rel_err(got, c64)[1],
                      "cpu_f32_vs_f64": rel_err(c32, c64)[1],
                      "card_vs_cpu_f32": rel_err(got, c32)[1]}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            ctl = t2w.bigvgan_forward.__wrapped__(bv_w, bcfg, cut,
                                                  device=dev).cpu()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    held["vocoder"]["tf32_control_vs_f64"] = rel_err(
        ctl, t2w.bigvgan_forward(_to_cpu(bv_w), bcfg, cut.cpu(),
                                 device="cpu", dtype=torch.float64))[1]
    for name, h in held.items():
        check(h["card_vs_f64"] <= OMNI_F64_RULE * h["cpu_f32_vs_f64"]
              + 1e-6,
              f"traffic AU: token2wav's {name} on the card {h} from the "
              "CPU's f64")
    t_c = time.perf_counter() - t_c
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "omni", "traffic": "AU (c) token2wav", "card": card(),
          "codes": OMNI_CODES, "mel_frames": frames, "samples": samples,
          **OMNI_T2W, "token2wav_s": t_wav, "dit_sample_s": t_mel,
          "tf32": "off inside token2wav (models/token2wav._no_tf32)",
          "held_against_f64": held,
          "dit_check_codes": OMNI_DIT_CHECK,
          "vocoder_check_frames": OMNI_VOCODER_CHECK})
    emit({"phase": "omni", "step": "seconds_by_part", "a": t_a, "b": t_b,
          "c": t_c, "peak_memory_bytes": peak})
    del lm, extra, talker
    torch.cuda.empty_cache()
    total = {k: launches.get(k, 0) + talker_launches.get(k, 0)
             for k in set(launches) | set(talker_launches)}
    return total, {"AU": per_step}


def _trace_clock(path):
    """Of a Chrome trace: the launches with no kernel record (dropped), and
    the least gap from a launch to its kernel's start, in ms (negative: the
    device's timestamps map before the host's)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {e["args"].get("correlation"): e["ts"] for e in events
               if e.get("cat") == "kernel"}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    gaps = [kernels[c] - e["ts"] for e in launches
            if (c := e["args"].get("correlation")) in kernels]
    return {"launches_without_kernel": len(launches) - len(gaps),
            "least_launch_to_kernel_ms": min(gaps) / 1e3 if gaps else None}


class _CharTok:
    """A character-level stub tokenizer (no download)."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [ord(c) % 97 for c in text]}


def phase_tools(dev):
    """The CLI's ``benchmark`` on a saved TinyLlama in a subprocess, a
    ``utils/profiling.trace`` of 8 of traffic A's decode steps read back by
    ``summarize_trace``, and ``eval/tasks``' multiple-choice scoring on
    seeded questions held by the rule against the plain path. Returns the
    launches of the traced steps."""
    import re
    import tempfile

    import numpy as np
    import torch

    import autoawq_tpu_torch
    from autoawq_tpu_torch.api import cast_params
    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.eval import tasks
    from autoawq_tpu_torch.io import serialize
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils import profiling
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(**TINYLLAMA)
    params = synth_zoo_params(cfg, 0, dev)
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(autoawq_tpu_torch.__file__)))
    layers = [{k: dict(v) if isinstance(v, dict) else v
               for k, v in lp.items()} for lp in params["layers"]]
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        serialize.save_quantized(d, cfg, AwqConfig(q_group_size=128),
                                 _unfused(cfg, {**params, "layers": layers}))
        t_save = time.perf_counter() - t
        cmd = [sys.executable, "-m", "autoawq_tpu_torch", "benchmark",
               "--model", d, "--contexts", "64", "--decode", "32"]
        t = time.perf_counter()
        res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=TOOLS_TIMEOUT)
        t_cli = time.perf_counter() - t
    del layers
    line = (res.stdout.strip().splitlines() or [""])[-1]
    check(res.returncode == 0
          and re.fullmatch(r"bs=1 ctx=64: decode [0-9.]+ tok/s", line),
          f"tools: the CLI's benchmark exited {res.returncode}: "
          f"{line!r} {res.stderr[-2000:]}")
    emit({"phase": "tools", "step": "cli", "card": card(),
          "command": "python -m autoawq_tpu_torch benchmark --model DIR "
                     "--contexts 64 --decode 32", "stdout": line,
          "save_s": t_save, "subprocess_s": t_cli})

    # the profiler over 8 of A's decode steps: K1's and K3's device kernels
    # by name against the launch counter (a K3 call is two kernels)
    steps = 8
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 64))).to(dev)
    caches = gen.init_kv_cache(cfg, 1, 64 + steps + 1, torch.bfloat16, dev)
    logits, _ = gen.prefill(cfg, params, prompt, caches)
    tok = logits.argmax(-1)[:, None]
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, device=dev):
            for i in range(steps):
                lg, _ = gen.decode_step(cfg, params, tok, caches, 64 + i)
                tok = lg.argmax(-1)[:, None]
        launches = dict(_build.LAUNCHES)
        rows = profiling.summarize_trace(d, top=None)
        clock = _trace_clock(os.path.join(d, "trace.json"))
    del caches
    held = _profile_vs_launches({n: c for n, _, c in rows}, launches)
    k1 = held.get("w4a16_gemv", (0, 0))[0]
    k3 = held.get("fused_mlp+fused_mlp3", (0, 0))[0]
    nl = cfg.num_hidden_layers
    _check_launches("tools trace", launches,
                    {"w4a16_gemv": 2 * nl * steps, "fused_mlp": nl * steps})
    check(all(seen == want for seen, want in held.values()),
          f"tools: summarize_trace counts {held} device kernels (seen, "
          f"implied) for {launches} launches")
    emit({"phase": "tools", "step": "trace", "card": card(),
          "decode_steps": steps, "launches": launches,
          "k1_device_kernels": k1, "k3_device_kernels": k3, **clock,
          "top": [{"name": n[:80], "us": us, "count": c}
                  for n, us, c in rows[:8]]})

    # multiple-choice scoring: the log-prob rows behind each choice's
    # log-likelihood on the kernel path against the plain twins in bf16
    # and f32, by the teacher-forced rule row by row
    rng = np.random.default_rng(17)
    words = ["river", "stone", "cloud", "ember", "maple", "harbor",
             "violet", "copper"]
    exs = [{"question": f"Which word is number {i}?",
            "choices": list(rng.choice(words, 4, replace=False)),
            "answer": int(rng.integers(0, 4))} for i in range(TOOLS_MMLU)]
    tok = _CharTok()
    t = time.perf_counter()
    acc = tasks.eval_multiple_choice(cfg, params, tok, exs)
    t_mc = time.perf_counter() - t
    p32 = cast_params(params, torch.float32)
    lls = []
    for ex in exs:
        ctx = tok(tasks.format_mmlu_prompt(ex["question"],
                                           ex["choices"]))["input_ids"]
        for letter in tasks.MMLU_CHOICES:
            cont = tok(" " + letter)["input_ids"]
            seq = torch.tensor([ctx + cont], device=dev)
            lp = {name: torch.log_softmax(modules.forward(
                cfg, tree, seq, method=m)[0, len(ctx) - 1:-1].float(), -1)
                for name, tree, m in (("kernel", params, "auto"),
                                      ("plain_bf16", params, "plain"),
                                      ("plain_f32", p32, "plain"))}
            at = torch.arange(len(cont), device=dev)
            rec = {name: float(v[at, torch.tensor(cont, device=dev)].sum())
                   for name, v in lp.items()}
            rec["api"] = tasks.choice_loglikelihood(cfg, params, ctx, cont)
            for i in range(len(cont)):
                f = lp["plain_f32"][i]
                k_rel = rel_err(lp["kernel"][i], f)[1]
                p_rel = rel_err(lp["plain_bf16"][i], f)[1]
                check(k_rel <= 2 * p_rel + 1e-3,
                      f"tools: a choice's log-prob row on the kernel path "
                      f"{k_rel:.3g} from f32, the bf16 twin {p_rel:.3g}")
            lls.append(rec)
    emit({"phase": "tools", "step": "multiple_choice", "card": card(),
          "questions": TOOLS_MMLU, "accuracy": acc, "eval_s": t_mc,
          "loglikelihoods": lls})
    del params, p32
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------------- examples and scripts

EXAMPLES_NEW = 16  # generate's new tokens (15 decode steps)
EXAMPLES_PROMPT = 300  # generate's prompt, one id a character: K2 and K4
EXAMPLES_TF_STEPS = 8  # generate's teacher-forced decode steps
EXAMPLES_ROUNDS = 2  # benchmark's (ctx, gen) rounds at bs1 (32 / 64)
EXAMPLES_KL = 2  # eval kldiv's seeded sequences of 256
EXAMPLES_SERVE = (8, 16)  # serve: requests (the pool's slots), new tokens
EXAMPLES_SSE = (64, 8)  # server --paged: prompt ids, new tokens
EXAMPLES_TRAIN = (3, 4, 512)  # train: steps, batch, length
EXAMPLES_QUANT_LAYERS = 2  # quantize: the float model's depth cut (of 22)
EXAMPLES_QUANT_CALIB = (16, 256)  # quantize: seeded calibration ids
EXAMPLES_KBENCH = ("1", "256")  # kbench's M: K1, then K2
# a profile's device kernels by launch name: (launch names, substrings of
# the kernels' names, names excluded, device kernels a launch). K3 and K8
# run the same two passes (ActOut, DownJob); K5's and K7's launches are
# counted by their combine kernels (K9's is ``stock_combine_kernel``)
PROFILE_KERNELS = (
    (("w4a16_gemv",), ("DenseJob",), (), 1),
    (("w4a16_gemm",), ("w4a16_gemm_kernel",), (), 1),
    (("fused_mlp", "fused_mlp3"), ("ActOut", "DownJob"), (), 2),
    (("prefill_attention",), ("prefill_attn_kernel",), (), 1),
    (("fused_attn_step",), ("attn_combine",), (), 1),
    (("paged_attn",), ("combine_kernel",), ("stock",), 1),
    (("prefill_attention_dkv",), ("dkv_kernel",), (), 1),
    (("prefill_attention_dq",), ("dq_kernel",), (), 1),
)


def _script(rel):
    """``examples/`` or ``scripts/`` of the checkout under test as a module
    (neither is a package), loaded once."""
    import importlib.util

    import autoawq_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        autoawq_tpu_torch.__file__)))
    name = "_cs_" + os.path.basename(rel)[:-3]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


class _ExampleTok:
    """A stand-in tokenizer for the examples on a machine without
    transformers: one id a character, ids decoded as ``<id>``, no EOS."""

    eos_token_id = None

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": self.encode(text)}

    def encode(self, text):
        return [ord(c) % self.vocab for c in text]

    def decode(self, ids, skip_special_tokens=False):
        return "".join(f"<{int(i)}>" for i in ids)


def _forward_launches(cfg, params, rows, s, k5=False, paged=False,
                      grad=False):
    """The port's launches for one pass of ``rows`` = B x ``s`` rows through
    a llama tree, by its routing rules: int4 linears on K1 below
    ``WS_MIN_M`` rows, K2 from there; the MLP on K3 (fused gate_up) or K8
    (gate and up apart) at M <= 32 without grad, else on the linears; K4
    for a prompt of s >= 128 (K10 and K11 with it under grad); K5 in place
    of the attention's linears (``k5``); K7 a layer on a paged step."""
    import collections

    from autoawq_tpu_torch.ops.gemm import WS_MIN_M

    n = cfg.num_hidden_layers
    attn = params["layers"][0]["self_attn"]
    fused = "qkv_proj" in attn
    quant = "qweight" in attn.get("qkv_proj", attn.get("q_proj"))
    lin = "w4a16_gemv" if rows < WS_MIN_M else "w4a16_gemm"
    out = collections.Counter()
    if k5:
        out["fused_attn_step"] += n
    elif quant:
        out[lin] += n * (2 if fused else 4)
    if paged:
        out["paged_attn"] += n
    if s >= 128:
        out["prefill_attention"] += n
        if grad:
            out["prefill_attention_dkv"] += n
            out["prefill_attention_dq"] += n
    if quant and rows <= 32 and not grad:
        out["fused_mlp" if fused else "fused_mlp3"] += n
    elif quant:
        out[lin] += n * (2 if fused else 3)
    return out


def _expected_call(attr, a):
    """``_forward_launches`` of one logged call of the functions the
    examples reach (their positional arguments ``a``)."""
    if attr in ("prefill", "forward"):
        cfg, params, tokens = a[:3]
        return _forward_launches(cfg, params, tokens.numel(),
                                 tokens.shape[1])
    if attr == "decode_step":
        cfg, params, token, caches = a[:4]
        b, t = token.shape[0], caches[0]["k"].shape[2]
        fused = "qkv_proj" in params["layers"][0]["self_attn"]
        return _forward_launches(cfg, params, b, 1, k5=fused and (
            b >= 8 or b * t >= 2048))
    if attr == "batched_decode_step":
        return _forward_launches(a[0], a[1], a[2].shape[0], 1)
    if attr == "paged_decode_step":
        return _forward_launches(a[0], a[1], a[2].shape[0], 1, paged=True)
    if attr == "lora_train_step_opt":
        cfg, lora, base, _, tokens = a[:5]
        return _forward_launches(cfg, base, tokens.numel(), tokens.shape[1],
                                 grad=True)
    raise ValueError(attr)


@contextlib.contextmanager
def _launch_calls(targets):
    """Within the block each (module, attr) of ``targets`` is wrapped: a
    call logs (attr, its launches, the launches its arguments imply by
    ``_expected_call``) to the list the block receives."""
    from autoawq_tpu_torch.ops import _build

    log, saved = [], []
    for module, attr in targets:
        fn = getattr(module, attr)

        def wrapper(*a, _fn=fn, _attr=attr, **kw):
            before = dict(_build.LAUNCHES)
            out = _fn(*a, **kw)
            got = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                   if n != before[k]}
            log.append((_attr, got, dict(_expected_call(_attr, a))))
            return out
        saved.append((module, attr, fn))
        setattr(module, attr, wrapper)
    try:
        yield log
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def _profile_vs_launches(counts, launches):
    """{kernel group: (device kernels in the profile, what the launch
    counter implies)} over ``PROFILE_KERNELS``."""
    out = {}
    for names, subs, unless, per in PROFILE_KERNELS:
        seen = sum(n for k, n in counts.items()
                   if any(s in k for s in subs)
                   and not any(u in k for u in unless))
        want = per * sum(launches.get(n, 0) for n in names)
        if seen or want:
            out["+".join(names)] = (seen, want)
    return out


def _run_example(name, fn, targets=(), profiled=True):
    """One example or script call: launches zeroed before it and read
    after; each call of ``targets`` held exactly against what its
    arguments imply, and their sum against the whole call's launches;
    with ``profiled`` the profile's device kernels held against the launch
    counter. Returns (the call's result, its launches, its seconds)."""
    import collections

    import torch

    from autoawq_tpu_torch.ops import _build
    from autoawq_tpu_torch.utils.profiling import device_kernels

    _build.reset_launches()
    timed = {}

    def run():
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t
        return out

    with _launch_calls(targets) as log:
        t = time.perf_counter()
        if profiled:
            out, _, kernels = device_kernels(run, torch.device("cuda"))
            counts = {k: n for k, (n, _) in kernels.items()}
        else:
            out, counts = run(), None
        # the example's own seconds; the profiler's set-up and read-back
        # apart
        seconds, profile_s = timed["s"], time.perf_counter() - t - timed["s"]
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    summed = {}
    for attr, got, want in log:
        want = {k: n for k, n in want.items() if n}
        check(got == want, f"examples {name}: a {attr} call launched {got}, "
              f"its arguments imply {want}")
        for k, n in got.items():
            summed[k] = summed.get(k, 0) + n
    if targets:
        check(summed == launches, f"examples {name}: {launches} launches "
              f"in the call, {summed} in its logged calls")
    held = None
    if counts is not None:
        held = _profile_vs_launches(counts, launches)
        for group, (seen, want) in held.items():
            check(seen == want, f"examples {name}: the profile holds {seen} "
                  f"{group} device kernels, the launch counter implies "
                  f"{want}")
    emit({"phase": "examples", "step": name, "card": card(),
          "seconds": seconds, "profile_s": profile_s, "launches": launches,
          "calls": collections.Counter(a for a, _, _ in log),
          "profile_vs_launches": held})
    return out, launches, seconds


def phase_examples(dev):
    """The port's examples and scripts in-process at TinyLlama-1.1B's full
    width and depth: ``make_artifact`` (the shared artifact, whose
    checkpoint the examples load, and its float model saved beside it),
    ``generate`` (a 300-id prompt: K2, K4; decode K1, K8 on the
    checkpoint's unfused layout; its rows by the teacher-forced rule),
    ``benchmark --synthetic tinyllama`` (two bs1 rounds: K1, K3), then on
    the artifact at bs8 (K2, K5, K3), ``eval --task kldiv`` against the
    float model, ``serve`` (8 requests on the slot pool: K1, K8),
    ``server --paged`` (one SSE request: K1, K7, K8), ``train`` (3 LoRA
    steps at 4 x 512: K2, K4, K10, K11), ``quantize`` (the float model cut
    to 2 layers), ``quality`` in artifact mode on that checkpoint and in
    trained mode (the gate), and ``kbench`` at M = 1 and 256. Each call's
    launches are held exactly, call by call, and (but the bs1 rounds',
    whose K1 and K3 the other calls read back) against the profile's
    device kernels. Returns the phase's launches."""
    import json as _json
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from autoawq_tpu_torch.api import AwqCausalLM
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.serve import batching, paged, server
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.train import lora as lora_mod

    ma = _script("scripts/torch_make_artifact.py")
    total, secs = {}, {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    gen_calls = ((gen, "prefill"), (gen, "decode_step"))
    with tempfile.TemporaryDirectory() as d:
        q_dir, fp_dir, cut_dir = (os.path.join(d, k)
                                  for k in ("awq", "fp", "fp_cut"))
        # 1. the shared artifact, and its float model beside it
        def make():
            cfg, fp, model = ma.main(["--out", q_dir])
            ma.save_fp_checkpoint(fp_dir, cfg, fp)
            cut = ModelConfig(**{**ma.CFG_KW,
                                 "num_hidden_layers": EXAMPLES_QUANT_LAYERS})
            ma.save_fp_checkpoint(cut_dir, cut, {
                **fp, "layers": fp["layers"][:EXAMPLES_QUANT_LAYERS]})
            return cfg
        cfg, launches, secs["make_artifact"] = _run_example(
            "make_artifact", make, profiled=False)
        check(not launches, f"examples make_artifact: launches {launches} "
              "(calibration takes the plain path)")
        check(os.path.isfile(os.path.join(q_dir, "ARTIFACT.json")),
              "examples make_artifact: no ARTIFACT.json")
        torch.cuda.empty_cache()
        tok = _ExampleTok(cfg.vocab_size)

        # 2. generate on the artifact: K2 and K4 in the prompt, K1 and K8
        # in decode, its rows by the teacher-forced rule
        prompt = "".join(chr(97 + i % 26) for i in range(EXAMPLES_PROMPT))
        out, launches, secs["generate"] = _run_example(
            "generate", lambda: _script("examples/torch_generate.py").main(
                ["--model", q_dir, "--prompt", prompt, "--max-new-tokens",
                 str(EXAMPLES_NEW)], tokenizer=tok), gen_calls)
        add(launches)
        check(tuple(out.shape) == (1, EXAMPLES_PROMPT + EXAMPLES_NEW),
              f"examples generate: output {tuple(out.shape)}")
        model = AwqCausalLM.from_quantized(q_dir)
        ids = torch.tensor([tok.encode(prompt)], device=dev)
        rows = _teacher_forced(cfg, model.params, ids, EXAMPLES_TF_STEPS)
        _check_teacher_forced("examples generate", rows)
        emit({"phase": "examples", "step": "generate rule", "card": card(),
              "kernel_vs_plain": rows})
        del model
        torch.cuda.empty_cache()

        # 3. benchmark: two bs1 rounds, then one at bs8 (K5 takes the step)
        bench = _script("examples/torch_benchmark.py")
        rows1, launches, t1 = _run_example(
            "benchmark bs1", lambda: bench.main(
                ["--synthetic", "tinyllama", "--rounds",
                 str(EXAMPLES_ROUNDS)]), gen_calls, profiled=False)
        add(launches)
        # bs8 on the artifact (fused at load): one synthetic draw the less
        rows8, launches, t8 = _run_example(
            "benchmark bs8", lambda: bench.main(
                ["--model", q_dir, "--rounds", "1", "--batch-size", "8"]),
            gen_calls)
        add(launches)
        check(launches.get("fused_attn_step", 0) > 0,
              "examples benchmark bs8: K5 never took the step")
        secs["benchmark"] = t1 + t8
        emit({"phase": "examples", "step": "benchmark rows", "card": card(),
              "rows": rows1 + rows8})
        torch.cuda.empty_cache()

        # 4. eval kldiv against the float model on seeded ids
        rep, launches, secs["eval"] = _run_example(
            "eval kldiv", lambda: _script("examples/torch_eval.py").main(
                ["--model", q_dir, "--task", "kldiv", "--ref", fp_dir,
                 "--n", str(EXAMPLES_KL)], tokenizer=tok),
            ((modules, "forward"),))
        add(launches)
        check(math.isfinite(rep["kl_mean"]) and rep["kl_mean"] > 0,
              f"examples eval kldiv: {rep}")
        torch.cuda.empty_cache()

        # 5. serve: the slot pool's 8 slots busy
        n_req, n_new = EXAMPLES_SERVE
        eng, launches, secs["serve"] = _run_example(
            "serve", lambda: _script("examples/torch_serve.py").main(
                ["--model", q_dir, "--max-batch", str(n_req),
                 "--max-seq-len", "256", "--max-new-tokens", str(n_new),
                 "--prompts"] + [f"request {i} " * (i + 1)
                                 for i in range(n_req)], tokenizer=tok),
            ((gen, "prefill"), (batching, "batched_decode_step")))
        add(launches)
        check(sorted(len(r.output) for r in eng.finished) == [n_new] * n_req,
              "examples serve: not every request ran to its budget")
        del eng
        torch.cuda.empty_cache()

        # 6. server --paged: one SSE request through K7
        s_len, s_new = EXAMPLES_SSE
        answer = {}

        def one_sse(engine, tokenizer, host, port, model_name, burst):
            es, httpd = server.start_server(engine, tokenizer, host, 0,
                                            model_name, burst=burst)
            try:
                body = _json.dumps({"prompt": list(range(5, 5 + s_len)),
                                    "max_tokens": s_new,
                                    "stream": True}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{httpd.server_address[1]}"
                    "/v1/completions", data=body,
                    headers={"Content-Type": "application/json"})
                toks = []
                with urllib.request.urlopen(req, timeout=300) as r:
                    for line in r:
                        line = line.strip()
                        if line.startswith(b"data:") and \
                                line[5:].strip() != b"[DONE]":
                            ch = _json.loads(line[5:])
                            if ch.get("choices"):
                                toks += ch["choices"][0].get("token_ids",
                                                             [])
                answer["tokens"] = toks
            finally:
                httpd.shutdown()
                es.shutdown()

        _, launches, secs["server"] = _run_example(
            "server --paged", lambda: _script(
                "examples/torch_server.py").main(
                ["--model", q_dir, "--paged", "--max-seq-len", "512"],
                tokenizer=tok, serve=one_sse),
            ((gen, "prefill"), (paged, "paged_decode_step")))
        add(launches)
        check(len(answer.get("tokens", [])) == s_new,
              f"examples server: {len(answer.get('tokens', []))} streamed "
              f"tokens, expected {s_new}")
        torch.cuda.empty_cache()

        # 7. train: LoRA steps at 4 x 512 on seeded synthetic-language ids
        steps, b, s = EXAMPLES_TRAIN
        losses, launches, secs["train"] = _run_example(
            "train", lambda: _script("examples/torch_train.py").main(
                ["--model", q_dir, "--dataset", "synthetic", "--steps",
                 str(steps), "--batch-size", str(b), "--seq-len", str(s),
                 "--lr", "1e-3", "--out", os.path.join(d, "lora.npz")]),
            ((lora_mod, "lora_train_step_opt"),))
        add(launches)
        check(all(math.isfinite(x) for x in losses),
              f"examples train: losses {losses}")
        emit({"phase": "examples", "step": "train loss", "card": card(),
              "losses": losses})
        torch.cuda.empty_cache()

        # 8. quantize the float model, cut to EXAMPLES_QUANT_LAYERS layers
        calib = np.random.default_rng(11).integers(
            0, cfg.vocab_size, EXAMPLES_QUANT_CALIB)
        _, launches, secs["quantize"] = _run_example(
            "quantize", lambda: _script("examples/torch_quantize.py").main(
                ["--model", cut_dir, "--out", os.path.join(d, "cut_awq")],
                tokenizer=tok, calib_data=calib), profiled=False)
        check(not launches, f"examples quantize: launches {launches}")
        check(os.path.isfile(os.path.join(d, "cut_awq", "config.json")),
              "examples quantize: no checkpoint written")
        torch.cuda.empty_cache()

        # 9. quality in artifact mode: the checkpoint make_artifact built
        # against its float model, AWQ's Δppl below RTN's
        rep, launches, secs["quality artifact"] = _run_example(
            "quality artifact", lambda: _script(
                "scripts/torch_quality.py").main(
                ["--mode", "artifact", "--artifact", q_dir, "--out",
                 os.path.join(d, "quality_artifact.json")]), profiled=False)
        check(not launches, f"examples quality artifact: launches "
              f"{launches}")
        d_awq = rep["awq_w4g128"]["delta_ppl"]
        d_rtn = rep["rtn_w4g128"]["delta_ppl"]
        check(d_awq < d_rtn, f"examples quality artifact: AWQ dppl {d_awq}, "
              f"RTN dppl {d_rtn}")
        emit({"phase": "examples", "step": "quality artifact",
              "card": card(), "fp_ppl": rep["fp32"]["ppl"],
              "rtn_ppl": rep["rtn_w4g128"]["ppl"],
              "awq_ppl": rep["awq_w4g128"]["ppl"], "rtn_delta_ppl": d_rtn,
              "awq_delta_ppl": d_awq,
              "awq_kl_mean": rep["awq_w4g128"]["kl_mean"],
              "rtn_kl_mean": rep["rtn_w4g128"]["kl_mean"]})
        torch.cuda.empty_cache()

    # 10. quality in trained mode: the gate
    rep, launches, secs["quality"] = _run_example(
        "quality trained", lambda: _script("scripts/torch_quality.py").main(
            ["--mode", "trained"]), profiled=False)
    check(not launches, f"examples quality: launches {launches}")
    fp_ppl = rep["fp32"]["ppl"]
    d_awq = rep["awq_w4g128"]["delta_ppl"]
    d_rtn = rep["rtn_w4g128"]["delta_ppl"]
    check(fp_ppl < 100 and d_awq <= 0.1 * fp_ppl and d_awq < d_rtn,
          f"examples quality: fp ppl {fp_ppl}, AWQ dppl {d_awq}, RTN dppl "
          f"{d_rtn}")
    emit({"phase": "examples", "step": "quality gate", "card": card(),
          "fp_ppl": fp_ppl, "rtn_ppl": rep["rtn_w4g128"]["ppl"],
          "awq_ppl": rep["awq_w4g128"]["ppl"], "rtn_delta_ppl": d_rtn,
          "awq_delta_ppl": d_awq, "awq_kl_mean": rep["awq_w4g128"][
              "kl_mean"], "rtn_kl_mean": rep["rtn_w4g128"]["kl_mean"],
          "final_train_loss": rep["config"]["final_train_loss"]})
    torch.cuda.empty_cache()

    # 11. kbench: K1 at M = 1, K2 at M = 256 (one warm call and a captured
    # graph of ITERS calls a shape)
    kb = _script("scripts/torch_kbench.py")
    rows, launches, secs["kbench"] = _run_example(
        "kbench", lambda: kb.main(list(EXAMPLES_KBENCH) + [
            "--out", os.path.join(tempfile.gettempdir(), "kbench.json")]),
        profiled=False)
    add(launches)
    per = len(kb.SHAPES) * (1 + kb.ITERS)
    _check_launches("examples kbench", launches,
                    {"w4a16_gemv": per, "w4a16_gemm": per})
    emit({"phase": "examples", "step": "kbench rows", "card": card(),
          "rows": rows})

    for name in ("w4a16_gemv", "w4a16_gemm", "fused_mlp", "fused_mlp3",
                 "prefill_attention", "fused_attn_step", "paged_attn",
                 "prefill_attention_dkv", "prefill_attention_dq"):
        check(total.get(name, 0) > 0,
              f"kernel {name} never launched on the examples phase's path")
    emit({"phase": "examples", "step": "seconds", "card": card(),
          "seconds_by_example": secs, "launches": total})
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose port is under test (default: "
                    "the one this script sits in)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    root = os.path.abspath(args.root)

    # the port under test is a checkout's (this script's by default), never
    # a copy installed elsewhere
    if not os.path.isdir(os.path.join(root, "autoawq_tpu_torch")):
        where = "beside this script" if root == HERE else f"in {root}"
        print(f"chip_smoke: no autoawq_tpu_torch/ {where}; run it from the "
              "root of a checkout", file=sys.stderr)
        return 1
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from autoawq_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device()
    rep, total, per_token, extra_rows = {}, None, {}, []

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        emit({"phase": name, "step": "seconds",
              "seconds": time.perf_counter() - t})
        return out

    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        rep, omni_rows = timed("kernels", phase_kernels, dev)
    if "e2e" in phases:
        total, per_token = timed("e2e", phase_e2e, dev)
    if "load" in phases:
        timed("load", phase_load, dev)
    if "quantize" in phases:
        counts = timed("quantize", phase_quantize, dev)
        if total is not None:  # the served checkpoint's launches count too
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if "zoo" in phases:
        counts, per_step = timed("zoo", phase_zoo, dev)
        per_token.update(per_step)
        if total is not None:
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if "mla_moe" in phases:
        counts, per_step, extra_rows = timed("mla_moe", phase_mla_moe, dev)
        per_token.update(per_step)
        if total is not None:
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if "serve" in phases:
        counts, per_step = timed("serve", phase_serve, dev)
        per_token.update(per_step)
        if total is not None:
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if "train" in phases:
        counts, per_step, rows = timed("train", phase_train, dev)
        extra_rows = extra_rows + rows
        per_token.update(per_step)
        if total is not None:
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if "parallel" in phases:
        timed("parallel", phase_parallel, dev)
    if "pipeline" in phases:
        timed("pipeline", phase_pipeline, dev)
    if "multimodal" in phases:
        counts, per_step, rows = timed("multimodal", phase_multimodal, dev)
        extra_rows = extra_rows + rows
        per_token.update(per_step)
        if total is not None:
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if "omni" in phases:
        counts, per_step = timed("omni", phase_omni, dev)
        per_token.update(per_step)
        if total is not None:
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if "tools" in phases:
        timed("tools", phase_tools, dev)
    if "examples" in phases:
        counts = timed("examples", phase_examples, dev)
        if total is not None:
            total = {k: n + counts.get(k, 0) for k, n in total.items()}
    if rep:  # the kernels phase's rows at Qwen2.5-Omni's shapes
        extra_rows = extra_rows + omni_rows
    if "prefill" in phases:
        timed("prefill", phase_prefill, dev)
    if "paged" in phases:
        timed("paged", phase_paged, dev)
    if "linears" in phases:
        timed("linears", phase_linears, dev)
    if "decode_mlp_attn" in phases:
        timed("decode_mlp_attn", phase_decode_mlp_attn, dev)
    if "attn_bwd" in phases:
        timed("attn_bwd", phase_attn_bwd, dev)
    if rep:
        kernels = []
        # the eleven kernels' representative rows, then the mla_moe phase's
        # K6 and K8 rows, the train phase's K1 and K2 rows, the
        # multimodal phase's K1-K4 rows and the kernels phase's K1, K3 and
        # K4 rows at Qwen2.5-Omni's shapes
        for name, r in [(n, rep[n]) for n in KERNEL_META] + [
                (r["kernel"], r) for r in extra_rows]:
            source, replaces = KERNEL_META[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "case": r.get("case"),
                # counts only from the main path's run; null without it
                "replaces": replaces,
                "launches": None if total is None else total.get(name, 0),
                "launches_per_decode_step": {
                    t: per[name] for t, per in per_token.items()},
                "shape": {k: r[k] for k in ("M", "K", "N", "B", "S", "H",
                                            "inter", "T", "vl", "cache",
                                            "experts", "top_k", "entries",
                                            "block_m", "nh", "nkv", "hd",
                                            "ps", "PPS", "pool",
                                            "live_rows")
                          if k in r},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "eager_ms": r["eager_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **({"matmul_per_expert_ms": r["matmul_per_expert_ms"]}
                   if "matmul_per_expert_ms" in r else {})})
        emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "failures": failures})
    if failures:
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
