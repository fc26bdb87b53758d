"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed 0] [--only kimi|norm]

Phases (one line each; any failure raises and the exit code is non-zero):
  1. the card: name and power limit (nvidia-smi), TF32 flags;
  2. build the CUDA kernels from open_o3_video_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the serving slice's
     shapes, bf16 on the card: max abs error vs a bound at the reference's
     scale and relative L2 error vs a bound (faults planted in K1's and
     K4's outputs must fail them), and times (CUDA events, warmup, median
     of 20, kernel and plain in turns); K1 at W = 64 (16 frames of 18x24
     patches, its row) and W = 128 (18x26); K2 also at frames of 32x32
     patches (W = 1024, past its resident limit: K and V stream); K3 also
     at the 72B judge's prefill (64/8 heads) and on run (b)'s last prefill
     chunk (8160 rows against 81920 slots: 64 rows compared, the whole
     chunk timed beside its bound and SDPA);
  4. the serving slice at the full width of Qwen2.5-VL-7B (random bf16
     weights drawn on the card from --seed): 2 requests of 16 synthetic
     252x336 frames, processor -> InferenceEngine.generate with the reference
     sampling (temperature 0.7, top_p 0.001, repetition penalty 1.05) for 64
     new tokens; stage times, peak memory, and each kernel's launch count,
     which must be > 0; the RMSNorm kernel's must be 57 (2 x 28 layers and
     the final norm) a prefill forward and a decode step, and 65 (2 x 32
     blocks and the merger's) a tower pass, in all and in the decode
     segments alone (norm_launches; phases 20, 22a and 26b hold their
     families' runs so too). Every phase decodes graphed, the engine's default:
     one decode step captured as a CUDA graph per group of a generate call
     and replayed, the tokens read back once a decode segment;
  5. the slice's numerics on the engine's prefill layout (the requests as
     one left-padded batch, a cache of L + 64 slots): vision embeddings and
     last-position prefill logits of the kernel path and of the plain bf16
     path (impl="torch"), each against a float32 reference (relative error
     and cosine; the kernel path may be at most SLICE_REL_RATIO further from
     it); the same requests decoded eagerly (decode_graph=False) must give
     the graphed run's tokens (every decoding path below is held so, with
     ms/token of both, the capture included, the speedup, the capture ms,
     wasted steps and kernel launches per step); then the early-stop
     check: a copy of the config whose EOS is the token that an eager
     greedy run emits at step 5, eager and graphed stopping at the same
     token, wasting at most the done flags' lag, DONE_LAG - 1 steps;
  6. the long-context path (the reference's max_model_len=81920): one
     text-only request per run through InferenceEngine.generate, greedy,
     repetition penalty 1.05, 32 new tokens: (a) a 32736-token prompt with a
     bf16 cache, (b) an 81888-token prompt with an fp8 e4m3 cache, prefilled
     in 8192-token chunks; stage times, peak memory, and K3 and K4 launch
     counts, which must be > 0 in each run;
  7. the long-context numerics: one decode step's logits on (b)'s prefilled
     fp8 cache with K4 (impl="auto") and with its plain version
     (impl="torch"), within LONG_LOGITS_REL / LONG_LOGITS_COS of each other
     and each against a float32 step (SLICE_REL_RATIO); then (a) and (b)
     again, decoding eagerly: the same tokens as the graphed runs.
  8. the training kernels against their plain versions at the SFT slice's
     shapes: the exact (training) modes of K1-K3, out and lse (K1's also at
     W = 128, K2's also at W = 1024, K3's also at 64/8 heads); K5 (dq; dk
     and dv) and K6 (fused dqkv, also at W = 128; the global blocks' dq; dk
     and dv), with their bounds and the time of one PyTorch call computing
     the same function; four planted faults must fail the bound (K5: dq from
     delta = 0, dk/dv over 6 of the 7 group heads; K6: the rope transpose
     left out, frame 0's segment mask ignored in dk/dv);
  9. the SFT slice: 3 full fine-tune steps of Qwen2.5-VL-7B through
     make_train_step on one example of 16 synthetic frames (SFTConfig
     defaults: AdamW lr 1e-6 after a global-norm clip at 1.0, remat), step
     1 first repeated without its update under the profiler; per step the
     seconds, loss, gradient norm and target tokens, the peak memory, and
     each training kernel's launch count, which must be > 0;
 10. the training numerics at full width and 8 ViT blocks / 2 decoder
     layers: loss and gradients of the kernel path and the plain bf16 path
     against float32, per group (ViT, decoder, embedding and lm_head).
 11. K7, the int4 matmul, against its plain version (bf16, the bound of
     phase 3) by the route its row count takes: decode (M <= 64, split-K)
     at the 7B gate_w, lm_head, k_w (N = 512) and down_w (K = 18944) and the
     72B down_w (231 groups), k_w and gate_w; prefill (wgmma) at the 7B
     gate_w and k_w and the 72B down_w (231 groups). Each with
     the bound, the bf16 torch.matmul on the dequantized weight and
     torch._weight_int4pack_mm on the same codes as yardsticks, and the
     same bits from two calls; two planted faults (nibbles swapped, scales
     one group off) must fail the bound. Then the K7a probes (stream,
     convert) and K7 at the TPU scripts' shape, 3584->18944 at M=16, chained
     over 8 weights as scripts/profile_int4_kernel_parts.py chains them;
 12. the 7B video slice with its decoder in int4 (quantize_params_int4 of
     the phase-4 weights, drawn again from --seed after phase 21): phase 4's requests and
     sampling through InferenceEngine.generate, stage times, weight and
     peak GiB, K7 launches by route (the prefill's 7 * 28 decoder matmuls
     on the wgmma route, its lm_head at the last positions and 7 * 28 + 1
     per decode step that ran on the mma.sync one), the same requests
     decoded eagerly giving the same tokens; the prefill logits of the K7
     path and of the plain int4 path each against float32 on the same int4
     weights (SLICE_REL_RATIO), and the int4-vs-bf16 distance as
     information;
 13. the judge: Qwen2.5-72B-Instruct at full width and depth (its published
     config.json) in int4 on the card, drawn and quantized leaf by leaf,
     EngineJudge.batch on 4 jobs with 16 new tokens, twice (the second
     call decoding eagerly, which must give the same tokens): init seconds,
     weight and peak GiB, prefill ms, decode ms/token, the scores (-1 with
     random weights), K7 launches by route as in phase 12 (7 * 80 on the
     wgmma route, then 1 + 7 * 80 + 1 per decode step that ran), K3's
     launches in the call (its prefill), and identical scores across the
     two calls.
 14. GSPO (after phase 10, before phase 11; run_grpo_video.sh under
     --use_peft): the phase-4 7B weights frozen, LoRA adapters (rank 16,
     alpha 32, q_proj/v_proj) from --seed, GSPOConfig defaults (G = 4, 768
     completion tokens, beta 0.04, clip 5.0, lr 1e-6) on one
     "temporal-spatial free-form QA" example (the slice's 16 frames and one
     keyframe through rl_sample_from_frames), row r of each group scored as
     the r-th of four canned grounded traces (random weights write text no
     reward scores; the real text's rewards are printed too). Step 1, a
     checkpoint, step 2; step 1's checkpoint restored and step 2 again: the
     same tokens, rewards, loss and kl. Per step the stage seconds, lengths,
     loss, kl, rewards, peak GiB, the rollout's decode ms/token and every
     kernel's launches (K1, K2, K3 in both modes and K5 > 0); B moved off
     0, the base bit for bit unchanged, no sample degraded and vision in
     the reference logps. Then one rollout of the trained policy at 128
     tokens a row, graphed and eager: the same tokens. Then the GSPO
     numerics at 8 ViT blocks / 2 decoder layers (policy logps and adapter
     gradients of the kernel and plain bf16 paths against float32,
     SLICE_REL_RATIO), and one full fine-tune step at full width, 8 ViT
     blocks and 4 decoder layers, against a frozen reference copy (K6 and
     the exact modes of K1 and K2 must launch).
 15. the SFT app (after phase 14, before phase 11): [media] probes g++, the
     libavformat, libavcodec, libavutil and libswscale headers and libraries
     and cv2, and prints the readers the port will use for videos and images
     (decided by the probe before anything is read). With a video reader: a
     raw AVI (32 frames of 252x336 at 16 fps) and a PNG keyframe written
     without an encoder (data/raw_media.py) in the reference's layout, read
     back exactly by every reader present (the native decoder built first,
     its build and decode times printed, when libav is there), fetch_video at
     16 frames. Then 3 PEFT SFT steps of the frozen 7B through
     make_lora_train_step (sft_main's default adapters: LoRA rank 16, alpha
     32 on q_proj/v_proj) on collate_sft_batch of the temporal-spatial
     example over those files (without a reader: collate_sft_frames on
     phase 9's synthetic frames): per step the seconds, loss, gradient norm,
     target tokens and peak GiB, the last step's device time by kernel
     class under the profiler; K1 and K2 in their inference modes, K3
     exact and K5 launched, K6 not; B moved off 0 and the base bit for bit
     unchanged. Then (with a reader) sft_main.main end to end under
     --use_peft on phase 10's cut of the model written as a checkpoint
     directory, over a two-example json (temporal-spatial, General video QA
     MCQ): run A 2 steps, run B 1 step, run C resuming B to 2; C's step 2
     loss and merged export must equal A's bit for bit.
 16. eval (16a after phase 15, before phase 11, on the phase-4 weights; 16b
     after phase 13): two lossless AVIs of 640x360 frames written without
     an encoder (20 s at 1 fps; 32 s at 2 fps); vstar.evaluate through the
     port's QwenVLEngine (configs/eval/vstar.yaml, max_tokens cut to 64) on
     3 items in V-STAR's layout, item_batch 2, one naming a missing video,
     which must land in *_errors.json: 16 frames an item as images resized
     to 336x588 (K2 at W = 1008), one engine call an item batch through
     the scheduler's 8 slots (its record: seconds, tower passes,
     admissions, prefix blocks, stage seconds; peak GiB; K1, K2 and K3
     launched); evaluate again decoding eagerly and item 0's call again
     graphed: each call's token ids equal, every row 64 tokens or ended by EOS (a
     [decode] line); tvgbench.evaluate on 3 queries, one a chunk (duration
     probed by the port's reader), graphed then eagerly: each chunk's
     token ids equal;
     evaluate_mcq_items_batched on a VideoMME-style item (video_mme.yaml:
     64 frames, N = 2, confidence_voting) and run_images_scorer_batch on
     the crops of a canned grounded trace (ratings in {-1, 0, 1, 2}); the
     eval CLI (`vstar --device cuda`) in a subprocess on phase 10's cut
     written as a checkpoint directory: the same items and keys. 16c (after
     the MCQ item, before the CLI): [tables] (pandas and pyarrow, which the
     dataloaders read with); VideoMME (3 items, one ASR transcript),
     WorldSense (3 items, one video truncated: recorded in its errors file;
     the score xlsx read back) and VideoMMMU (one item per split, the
     Adaptation item with a PNG query image) over synthetic datasets in
     their layouts, 64-frame 640x360 AVIs named <id>.mp4, each harness
     through a QwenVLEngine at its own yaml (max_tokens cut to 64),
     item_batch 2: every item in its results file, K1, K2 and K3 launches
     per engine call (28 and 4 per tower pass, 28 per prefill forward of
     the call's record), the Adaptation request one grid entry longer than
     the frames alone; VideoMMMU again eagerly: each call's token ids
     equal; then the CLI step runs
     `videommmu --device cuda` too: the same items and keys. 16b: the
     72B int4 judge of phase 13 scores the V-STAR results through
     evaluate_json (empty answers filled with a canned one, counted): the
     overall block (acc, mAM, mLGM) and K7's launches on both routes.
 17. the serving scheduler (after phase 16a, before phase 11, on the
     phase-4 weights): K4 at query position T on a wrapped ring (two rows
     over 32768 + 48 columns, valid columns on both sides of the write
     head) against its plain version, and a planted read that stops at the
     write head must fail the bound; K3 at a suffix admission's layout
     (17a's prefix group: 5 suffix rows at cache offset P over a mask with
     a hole before the block and the suffixes' left pad) against its plain
     version, with three planted layout faults that must fail the bound;
     17a one InferenceEngine.generate of 14 requests (2 synthetic 16-frame
     252x336 videos with 5 queries each, question tails of 20-300 tokens,
     and 4 text-only prompts of 500-3000 tokens) with max_slots 8,
     decode_segment 16, 48 greedy tokens, repetition penalty 1.05:
     admissions, segments, ring wraps (>= 1), prefix blocks (2), tower
     passes (2), stage seconds, capture ms, peak GiB, K1/K2/K3 launches
     (> 0), then the same call eagerly: equal token ids; 17b the call with
     prefix_cache_min=0: prefill seconds of both and the share of equal
     rows; every prefix-cached row's first-token log-probability within
     SCHED_LOGP_BOUND of a plain prefill's log-probability of that token,
     and past it with the two videos' blocks swapped and with the blocks
     zeroed; a second reading, each block's K/V against a plain prefill's
     K/V of the same columns, within SCHED_KV_REL_BOUND and past it with
     the blocks moved one column right (which the first reading passes);
     17c max_slots 2, prefill_chunk 2048: an 8000-token request
     admitted in chunks while a 1000-token one decodes (>= 3 decode
     segments between chunks), graphed and eagerly equal; 17d max_kv_gb set
     to admit 3 of 8 slots of 17a's 11-request group: the slots used, every
     arena within the budget.
 18. speculative decoding (after phase 17, before phase 11, on the phase-4
     weights): K4 at S = K1 = 8 query rows (1 x 40000 fp8, whose block keys
     carry much of the attention, and 4 x 33000 bf16 with holes) and K3 at
     S = 8 over a sampled arena of GSPO's geometry (decode_attn_impl
     "pallas"), each against its plain version with its bound and SDPA, and
     a planted K4 whose block rows each see the key after their own, which
     must fail the bound; 18a the slice's first request (2939 tokens)
     greedy, repetition penalty 1.0, 64 tokens with spec_decode
     (spec_draft 7) and plain, each after a warm-up call: the first index
     where the tokens differ and, there, the plain step's top-2 logit gap
     (at most SPEC_TIE_GAP), verify steps and their graph captures, tokens
     per verify, decode ms/token of both; 18b a PEFT GSPOTrainer with
     spec_rollout (G = 4, 768 tokens, phase 14's example): one step
     sampling at random init ("worst": the probe must revert the group),
     one step replaying a grounded trace (reasoning_trace_tokens, the JAX
     bench's trace generator; warmup and probe off: every stream must equal its
     trace), each step's rollout seconds against a plain rollout of the same
     requests, tokens per verify, compactions, peak GiB; 18c run (a)'s
     prompt (32736 tokens, bf16 cache) greedy with spec_decode, 32 tokens:
     K4 must launch in the verify blocks, the tokens against run (a)'s as
     in 18a.
 19. the uint8 frame path and w8a8 serving (after phase 18, before phase
     11, on the phase-4 weights): 19a the slice's two requests greedy (64
     tokens, penalty 1.05) as host patches, as Request.frames and through
     prestage_frames on a prefetch thread (during the frames call): each
     way's tower input against the host path's (max abs difference 0),
     equal tokens, bytes uploaded, vis_upload/vision/prefill ms; then phase
     16's 640x360 AVI read by fetch_video_raw (16 frames, the eval's pixel
     budget): the device resize against the host resize (pixels that
     differ, their share, the largest difference, at most 1 LSB, with TF32
     off and on around it: equal), and the frames + resize_hw request's
     tokens against the host-resized patches' (equal unless a pixel
     differs; else the first difference and plain's top-2 gap); 19b the
     JAX bench's quality leg on the first request's frames, 64 greedy
     tokens at penalty 1.0: bf16, w8 (quantize_text) and w8a8
     (quantize_text + quantize_vision + a8_prefill), per mode the
     teacher-forced and free-run agreement with bf16, vision, prefill and
     decode ms, weight and peak GiB, torch._int_mm calls per tower pass
     (5 x 32), prefill forward (7 x 28), lm_head (1) and decode (0); 19c
     run (b)'s prompt with int8 text weights without and with a8_prefill
     (the JAX bench's 81920:fp8:a8): prefill s, the first 8 tokens.
 20. Qwen3-VL-8B and Qwen2-VL-7B (after phase 19, before phase 11; the
     7B stays resident): 20a K2 at head_dim 72 (16 heads, Qwen3-VL's tower)
     against its plain version at whole frames of W = 352 (resident) and
     784 (streamed), and at head_dim 80 over Qwen2-VL's W = 432, each with
     its bound and SDPA; the neighbour head's columns: the even heads'
     outputs bit-equal with the odd heads scaled by 64, and scores over 8
     columns of the next head must fail the bound; K3 at Qwen3-VL's
     prefill (32/8 heads); 20b Qwen3-VL-8B from its published config
     (random bf16 weights from --seed): the slice's 2 questions over 16
     frames of 256x352 as images (the processor at patch 16), greedy, 64
     tokens: vision, prefill and decode ms, peak GiB, K2 launches 27 a
     tower pass, K1 none, K3 36 a prefill forward, the RMSNorm kernel 145
     a forward (4 x 36 and the final norm), graphed tokens equal to
     eager, the tower (and its 3 deepstack taps) of the kernel path against
     float32 as phase 5, the teacher-forced argmax agreement of the kernel
     path with impl="torch", and zeroing the taps must move the logits;
     then one video request (Request.frames, 8 frames resized on the card
     to 448x448, grid (8, 28, 28), a timestamp and a vision block per
     frame): K2 streamed, 27 launches; 20c Qwen2-VL-7B from its published
     config on phase 4's requests: K2 on all 32 blocks (W = 432), graphed
     = eager, the tower against float32. Each model is freed before the
     next is drawn.
 21. training Qwen3-VL-8B and Qwen2-VL-7B (after phase 20, before phase
     11; the 7B is released first and drawn again from --seed after): 21a
     K2's exact mode (out, lse) and K6's dq and dk/dv against their plain
     versions at head_dim 72 over W = 352 (16 frames, resident) and 784 (8,
     streamed) and at 80 over Qwen2-VL's W = 432, frame 0 ending in 32 pad
     rows, each with its bound and SDPA forward (+ backward); at W = 352 the
     even heads' five outputs bit-equal with the odd heads' inputs x8, and
     three planted faults must fail the bound (dq over 8 columns of the
     next head, dq from delta = 0, dk/dv with frame 0's mask ignored); 21b
     3 full fine-tune steps of Qwen3-VL-8B (its published config, random
     bf16 weights from --seed) through make_train_step at SFTConfig
     defaults on phase 9's example over 16 frames of 256x352 as images:
     seconds, loss, gradient norm and peak GiB a step, K2 exact, K6, K3
     exact and K5 launched, K1 never; then the training numerics at 9 ViT
     blocks (the tap after block 8 kept) and 2 decoder layers as phase 10,
     the deepstack mergers a group of their own; 21c 2 PEFT steps (LoRA
     rank 16 on q/v): K2 inference, no K6, the base bit for bit; 21d a PEFT
     GSPO step of Qwen3-VL-8B at GSPOConfig defaults on phase 14's example
     over its frames, canned rewards, then a full fine-tune GSPO step at 9
     ViT blocks and 4 layers against the frozen originals (K6 at 72
     launched); 21e one full fine-tune step of Qwen2-VL-7B on phase 9's
     batch (K2 exact and K6 at W = 432).
 22. Qwen3-VL-30B-A3B and Aria, served (after phase 21, before phase 11;
     the 7B is drawn again after it): 22a K2 at head_dim 72 under the 30B's
     tower (W = 352) and K3 at its prefill (32/4 heads) against their plain
     versions, each with its bound and SDPA; Qwen3-VL-30B-A3B-Instruct from
     its published config (random bf16 weights from --seed; the parameter
     count must equal HF's model's, 31.07B): phase 20's two image requests
     and its video request greedy, 64 tokens, graphed and eagerly (tokens
     equal): vision, prefill and decode ms, peak GiB, K2 27 a tower pass, K3
     48 a prefill forward, the RMSNorm kernel 193 a forward (4 x 48 and the
     final norm; none in the LayerNorm tower), the decode step's weight bytes (routed at most,
     and the dense form's); the MLP numerics at 2 decoder layers: the
     routed experts in bf16 and the dense combine in bf16, each against the
     dense combine in float32 on the same experts, the routed at most
     SLICE_REL_RATIO further; the renormalisation skipped, a softmax of the
     probabilities and the inverse permutation left out must exceed that
     bound (Aria's routing, the same function, must not); 22b Aria from its
     published config (25.3B within 5%, and HF's count): one 980x980 image
     through get_image_features (4900 patches, 256 queries; tower and
     projector ms), then a text request and two requests over the features
     as Request.vision_embeds sharing a prefix, greedy, 64 tokens, graphed
     and eagerly (tokens equal): prefill and decode ms, peak GiB, K3 28 a
     prefill forward, one prefix block, no tower pass, no upload; the
     prefix-served request against itself served plain (equal, or a first
     divergence at a top-2 gap of at most SPEC_TIE_GAP); 22c K3 at Aria's
     prefill (20/20 heads, a GQA group of 1) against its plain version.
 23. training Qwen3-VL-30B-A3B and Aria (after phase 22, before phase 11;
     random bf16 weights from --seed, each model freed before the next is
     drawn): 23a the 30B at full width and depth, 2 PEFT SFT steps (LoRA
     rank 16, alpha 32 on q/v) on phase 21's batch (16 frames of 256x352,
     2762 tokens): seconds, loss, gradient norm, peak GiB, K2 27 a step in
     the frozen tower, K3 exact 96 and K5 48 + 48 a step (remat), no K2
     exact or K6, the base unchanged (its fingerprint: a copy does not fit
     beside 57.9 GiB), B moved; a PEFT GSPO step at GSPOConfig's defaults
     on phase 21's sample with canned traces; then at 9 ViT blocks and 4
     decoder layers (all 128 experts each) 3 full fine-tune SFT steps (K2
     exact and K6 at 72), the training numerics as phase 10, the routed
     MLP's backward against the dense form's at 2 layers over 1244 tokens
     (router, expert stacks and input in bf16, each at most
     SLICE_REL_RATIO further from float32 than the dense bf16 form's;
     experts that got no token exactly 0; the routing weights detached, a
     zero router gradient, must exceed the bound), and a full fine-tune
     GSPO step against the frozen originals; 23b Aria the same way on one
     980x980 image inside 300 text tokens (556 tokens; no tower kernel: the
     tower is plain attention), its GSPO rollouts through vision_embeds
     with one tower pass for the G rows, its full fine-tune at 4 tower
     blocks and 2 layers (the tower's held GiB a block logged); 23c K3's
     exact mode and K5 at the 30B's SFT shape (1 x 2762, 32/4 heads) and
     Aria's (1 x 556, 20/20), each with its bound, plain time and SDPA,
     and K4 at Aria's group of 1 (32768 bf16 slots; logged, off every
     main path).
 24. serving on a mesh (last, after phase 13; the 7B drawn again from
     --seed): 24a a one-rank NCCL mesh (MASTER_ADDR/MASTER_PORT set here,
     parallel.make_mesh), InferenceEngine(mesh=...) on phase 4's requests,
     bf16 and then int4 (quantize_params_int4), graphed and eagerly: tokens
     and return_logprobs bit-equal to the mesh-less engine's (every
     collective is an identity at one rank), ms/token of both, the
     collectives captured in a decode graph, K1-K3 (and K7) launched; 24b
     the kernels at the shapes a tensor group gives each rank, against
     their plain versions with bounds and library times: K1 and K2 at 8
     and 4 of 16 ViT heads, K3 at the 7B's 14/2 and 7/1 heads and the
     72B judge's 8/1, K4 at 7/1 over 81920 fp8 slots, K7 on the 72B
     down_w's N / 4 shard by both routes (its gate_w shards are not K7
     shapes at any tensor > 1: logged); 24c two gloo ranks on the one card
     (this script started again with --mesh-rank; NCCL refuses two ranks
     on one device, gloo takes CUDA tensors) serving the 7B at tensor = 2,
     full width, eager: its teacher-forced logits of the last
     MESH_TF_ROWS prompt positions at most SLICE_REL_RATIO times the
     one-rank bf16 forward's relative distance from float32, top-1 and
     greedy agreement with one rank, both ranks' tokens equal, their
     launches (the _tp2 rows'); 24d 24a's greedy answer rendered over its
     frames as a GIF by eval/visualization.py with jax and PIL blocked:
     frames and bytes.
 26. Kimi-VL-A3B (last; alone with --only kimi, after the card and the
     build): 26a the MLA decode (8 x 18700 latent columns, the
     longvideo.kimi-vl-a3b cell's step; 1 x 8 rows x 40000) and prefill
     (the cell's 18262-row prefix block, 256 of its rows compared, the
     whole block timed with its bound and causal SDPA; its 8 x 96-row
     suffix admission) against their plain versions, three planted faults
     that must fail the bound (rope part left out, the scale of head_dim
     128, k_pe left out), and K2 at MoonViT's 64 frames of W = 1008,
     head_dim 72, with its bound, plain and SDPA times; 26b Kimi-VL at full
     width with 3 decoder layers and 4 tower blocks through
     InferenceEngine.generate (8 frames resized on the card, three
     questions sharing the video prefix, 16 greedy tokens): K2, MLA prefill
     and MLA decode launches must equal blocks x tower passes, layers x
     prefill forwards and layers x decode steps, the RMSNorm kernel 3 x
     layers + 1 a forward, and the eager decode must give the graphed run's
     tokens.
 27. RMSNorm (last; alone with --only norm, after the card and the build):
     the kernel against its plain version (every output within one bf16
     ulp) at the cells' shapes (8 x 2048, 8 x 3584, 256 x 128, 8 x 512 rows
     576 apart, 16384 x 1280, 317952 x 1280): one LAUNCHES count and
     exactly one device kernel a call by the profiler (the plain chain's
     and F.rms_norm's kernels counted beside it), F.rms_norm's ulps from
     the chain, times in turns with the byte bound and F.rms_norm's, and at
     the decode shapes each one's share of a replayed CUDA graph of
     NORM_GRAPH_CALLS calls, as the decode step pays it; with --only norm
     also 27b, a cut 7B (8 tower blocks, 4 layers, full width) through
     generate, its RMSNorm launches held as phase 4's (the kernels line's
     launches: phase 4's run, or 27b's alone). The whole script runs 27 as
     a process of its own (``--only norm``): late in a long process the
     profiler read no device kernels.
Then one JSON line with the per-kernel results, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it raises before any
result is printed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import filecmp
import gc
import importlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from open_o3_video_tpu_torch.data import video as TV
from open_o3_video_tpu_torch.data.processor import O3VideoProcessor
from open_o3_video_tpu_torch.data.raw_media import write_png, write_raw_avi
from open_o3_video_tpu_torch.data.sft_dataset import (
    collate_sft_batch,
    collate_sft_frames,
    pack_sft_batch,
    prepare_sft_example,
)
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.engine import engine as engine_module
from open_o3_video_tpu_torch.engine.engine import DONE_LAG, left_padded_rows
from open_o3_video_tpu_torch.eval.judge import QWEN25_72B_INSTRUCT_CONFIG, EngineJudge
from open_o3_video_tpu_torch.models import aria, family_forward, is_aria
from open_o3_video_tpu_torch.models import kimi_vl
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig, params as P
from open_o3_video_tpu_torch.models.qwen25vl import text as TT
from open_o3_video_tpu_torch.models.qwen25vl.config import (
    QWEN2_VL_7B_INSTRUCT_CONFIG,
    QWEN3_VL_8B_INSTRUCT_CONFIG,
    QWEN3_VL_30B_A3B_INSTRUCT_CONFIG,
)
from open_o3_video_tpu_torch.models.qwen25vl.model import (
    build_vision_row_index,
    embed_tokens,
    encode_vision,
    get_rope_index,
    merge_vision_embeddings_by_index,
)
from open_o3_video_tpu_torch.models.qwen25vl.model import forward as model_forward
from open_o3_video_tpu_torch.models.qwen25vl.text import (
    init_kv_cache,
    logits_from_hidden,
    text_forward,
)
from open_o3_video_tpu_torch.models.qwen25vl.vision import compute_vision_spec
from open_o3_video_tpu_torch.ops import kernels
from open_o3_video_tpu_torch.ops import decode_attention as da
from open_o3_video_tpu_torch.ops import flash_attention as fa
from open_o3_video_tpu_torch.ops import int4 as i4
from open_o3_video_tpu_torch.ops import mla
from open_o3_video_tpu_torch.ops import quant
from open_o3_video_tpu_torch.ops import rms_norm as rn
from open_o3_video_tpu_torch.ops import window_attention as wa
from open_o3_video_tpu_torch.ops.resize import resize_frames_device
from open_o3_video_tpu_torch.data.rl_dataset import rl_sample_from_frames
from open_o3_video_tpu_torch.grounding.prompts import SFT_SYSTEM_PROMPT
from open_o3_video_tpu_torch.grounding.rewards import REWARD_REGISTRY, sum_rewards
from open_o3_video_tpu_torch.native import video_decoder
from open_o3_video_tpu_torch.train import (
    SFTConfig,
    loss_and_grads,
    make_lora_train_step,
    make_optimizer,
    make_train_step,
)
from open_o3_video_tpu_torch.train import checkpoint as CKPT
from open_o3_video_tpu_torch.train import sft_main
from open_o3_video_tpu_torch.train.gspo import GSPOConfig, GSPOTrainer, gspo_loss, completion_logps
from open_o3_video_tpu_torch.train.lora import (
    LoraConfig,
    adapter_leaves,
    apply_adapters,
    init_adapters,
)

# The reference's system prompt for grounded free-form video QA
# ("temporal-spatial free-form QA"), so the prompt has its real length.
SYSTEM_PROMPT = (
    "A conversation between user and assistant. The user provides a video and asks a "
    "question, and the Assistant solves it. The assistant MUST first think about the "
    "reasoning process in the mind and then provide the user with the answer. The reasoning "
    "process and answer are enclosed within <think> </think> and <answer> </answer> tags, "
    "respectively. All reasoning must be grounded in visual evidence from the video. When you "
    "mention any related object, person, or specific visual element in the reasoning process, "
    "you must strictly follow the following format: "
    "`<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. The answer "
    "part only requires a text response; tags like <obj>, <box>, <t> are not needed."
)
# One request per question; their lengths differ, so one row is left-padded.
QUESTIONS = ["What is the color of the bowling ball?", "What is the first scene about?"]
N_FRAMES, FRAME_H, FRAME_W, FPS = 16, 252, 336, 2.0
MAX_TOKENS = 64

# Kernel vs plain version, bf16 on the card. At outputs of unit scale one
# bf16 ulp at |x| < 2 is 2^-7, and the kernel's summation order can also flip
# the bf16 rounding of single probabilities; the max abs error is bounded by
# KERNEL_ATOL times the reference's scale, min(1, max|ref|). Attention over t
# random keys gives outputs ~sqrt(e/t) (0.006 at t = 81888), so a bound at
# unit scale would be as large as the output itself. The relative L2 error is
# bounded too: one ulp flip moves an element by at most 2^-7 of itself, while
# dropping n of t keys moves the output by ~sqrt(n/t) (decode_cases plants
# such faults, which must fail).
KERNEL_ATOL = 2e-2
KERNEL_REL_L2 = 1e-2
# Whole slice (numerics_phase): the kernel path's relative error against a
# float32 reference may exceed the plain bf16 path's by at most this factor.
# Both errors are dominated by the bf16 rounding the two paths share; their
# own rounding differences add in quadrature, so equal accuracy gives a
# ratio near 1, and a wrong kernel (errors of order 1) a ratio far above.
SLICE_REL_RATIO = 1.25
# Long-context numerics: K4 vs its plain version inside one full-width decode
# step. Only K4 differs between the two runs, at one query position, so the
# logits may differ by bf16 rounding carried through 28 layers; bounded by
# the whole-prefill kernel/plain difference of the slice (4.5% in logits).
# Both bf16 steps are also held to a float32 step on the same cache: the K4
# step may be at most SLICE_REL_RATIO further from it than the plain one.
LONG_LOGITS_REL = 0.05
LONG_LOGITS_COS = 0.998

# The long-context runs: (name, prompt tokens, cache dtype). T = prompt + 32
# slots: 32768 and 81920 (the reference's max_model_len).
LONG_RUNS = (("a", 32736, torch.bfloat16), ("b", 81888, torch.float8_e4m3fn))
LONG_NEW_TOKENS = 32
LONG_CHUNK = 8192  # the engine's long_prefill_chunk
K4_TILE_KEYS = da.TILE_KEYS  # K4's key tile (kTile in csrc/decode_attention.cu)

TPU_KERNELS = {
    "fused_window_attention": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                               "open_o3_video_tpu/ops/window_attention.py:359"),
    "window_attention": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                         "open_o3_video_tpu/ops/window_attention.py:112"),
    "flash_attention_gqa": ("open_o3_video_tpu_torch/csrc/flash_attention.cu",
                            "open_o3_video_tpu/ops/flash_attention.py:48"),
    "decode_attention_gqa": ("open_o3_video_tpu_torch/csrc/decode_attention.cu",
                             "open_o3_video_tpu/ops/decode_attention.py:103"),
    # the training (exact) modes of K1-K3, and K5 and K6
    "fused_window_attention_exact": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                                     "open_o3_video_tpu/ops/window_attention.py:359"),
    "window_attention_exact": ("open_o3_video_tpu_torch/csrc/window_attention.cu",
                               "open_o3_video_tpu/ops/window_attention.py:112"),
    "flash_attention_gqa_exact": ("open_o3_video_tpu_torch/csrc/flash_attention.cu",
                                  "open_o3_video_tpu/ops/flash_attention.py:48"),
    "flash_attention_gqa_bwd_dq": ("open_o3_video_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "open_o3_video_tpu/ops/flash_attention.py:246"),
    "flash_attention_gqa_bwd_dkv": ("open_o3_video_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "open_o3_video_tpu/ops/flash_attention.py:295"),
    "fused_window_attention_bwd": ("open_o3_video_tpu_torch/csrc/window_attention_bwd.cu",
                                   "open_o3_video_tpu/ops/window_attention.py:406"),
    "window_attention_bwd_dq": ("open_o3_video_tpu_torch/csrc/window_attention_bwd.cu",
                                "open_o3_video_tpu/ops/window_attention.py:158"),
    "window_attention_bwd_dkv": ("open_o3_video_tpu_torch/csrc/window_attention_bwd.cu",
                                 "open_o3_video_tpu/ops/window_attention.py:158"),
    # K7, and the K7a probes of the TPU profiling scripts
    "int4_matmul": ("open_o3_video_tpu_torch/csrc/int4_matmul.cu",
                    "open_o3_video_tpu/ops/int4.py:107"),
    "int4_matmul_wgmma": ("open_o3_video_tpu_torch/csrc/int4_matmul_sm90.cu",
                          "open_o3_video_tpu/ops/int4.py:107"),
    "int4_matmul_stream": ("open_o3_video_tpu_torch/csrc/int4_matmul.cu",
                           "scripts/profile_int4_kernel_parts.py:61"),
    "int4_matmul_convert": ("open_o3_video_tpu_torch/csrc/int4_matmul.cu",
                            "scripts/profile_int4_kernel_parts.py:84"),
}
# Phase 20's cases of K2 and K3, each with its row: K2 at head_dim 72 on
# Qwen3-VL-8B's images and video, K2 at 80 on every block of Qwen2-VL-7B,
# K3 at Qwen3-VL-8B's prefill.
FAMILY_CASES = {
    "window_attention_d72_w352": TPU_KERNELS["window_attention"],
    "window_attention_d72_w784": TPU_KERNELS["window_attention"],
    "window_attention_qwen2vl": TPU_KERNELS["window_attention"],
    "flash_attention_gqa_qwen3": TPU_KERNELS["flash_attention_gqa"],
}
# Phase 21's rows: K2's exact mode and K6's dq and dk/dv at head_dim 72
# (Qwen3-VL-8B, W = 352) and at 80 over Qwen2-VL-7B's W = 432.
FAMILY_TRAIN_CASES = {
    f"{name}{suffix}": TPU_KERNELS[name]
    for suffix in ("_d72", "_qwen2vl")
    for name in ("window_attention_exact", "window_attention_bwd_dq", "window_attention_bwd_dkv")
}
# Phase 22's rows: K2 at head_dim 72 under Qwen3-VL-30B-A3B's tower, K3 at
# its prefill (32 q heads over 4 KV heads) and at Aria's (20 over 20: a
# GQA group of 1).
MOE_FAMILY_CASES = {
    "window_attention_d72_qwen3_moe": TPU_KERNELS["window_attention"],
    "flash_attention_gqa_qwen3_moe": TPU_KERNELS["flash_attention_gqa"],
    "flash_attention_gqa_aria": TPU_KERNELS["flash_attention_gqa"],
}
# The kernels each main path must launch.
SLICE_KERNELS = ("fused_window_attention", "window_attention", "flash_attention_gqa")
LONG_KERNELS = ("flash_attention_gqa", "decode_attention_gqa")
TRAIN_KERNELS = tuple(list(TPU_KERNELS)[4:12])
K7_ROUTES = ("int4_matmul", "int4_matmul_wgmma")  # decode, prefill (i4.kernel_route)
INT4_SLICE_KERNELS = SLICE_KERNELS + K7_ROUTES
PROBE_KERNELS = ("int4_matmul_stream", "int4_matmul_convert", "int4_matmul")
# K7 (phase 11): (case, M, K, N) at the main paths' shapes; the first case
# of each route gives its row. M None: the 7B slice's prefill, its 2 rows of
# L tokens; M 3984: the judge's prefill, 4 jobs of up to 996 tokens.
INT4_CASES = (("7B decode gate_w", 2, 3584, 18944), ("7B prefill gate_w", None, 3584, 18944),
              ("7B decode lm_head", 2, 3584, 152064), ("72B decode down_w", 4, 29568, 8192),
              ("7B decode k_w", 2, 3584, 512), ("7B decode down_w", 2, 18944, 3584),
              ("72B decode k_w", 4, 8192, 1024), ("72B decode gate_w", 4, 8192, 29568),
              ("7B prefill k_w", None, 3584, 512), ("72B prefill down_w", 3984, 29568, 8192))
# The K7a probes' shape and chain (scripts/profile_int4_kernel_parts.py:
# 3584 -> 18944 at M = 16, a scan over distinct weights).
PROBE_M, PROBE_K, PROBE_N, PROBE_CHAIN = 16, 3584, 18944, 8
# Outputs of the int4 comparisons have std ~0.25 (weights scaled by
# 1/sqrt(K)): below 2 one bf16 ulp is within KERNEL_ATOL.
INT4_OUT_STD = 0.25
# The judge (phase 13): the reference's eval_vstar.py judge, greedy.
JUDGE_JOBS = (
    ("What is the color of the bowling ball?", "It is red.", "The ball is red."),
    ("What happens first?", "A man rolls a ball down the lane.", "A dog runs across a field."),
    ("How many pins fall?", "All ten pins fall.", "Most of the pins fall down."),
    ("Where is the bowler standing?", "At the foul line.", "Near the foul line of the lane."),
)
JUDGE_NEW_TOKENS = 16
# The judge's prompts in ByteTokenizer tokens (phase 13 prints them), for K3
# at the judge's prefill shape in phase 3.
JUDGE_PROMPT_ROWS = (982, 990, 991, 996)
# The SFT slice: one grounded example over the serving slice's 16 frames,
# with the reference's SFT system prompt and temporal frame prompt, and a
# target of a few hundred bytes in the reference's answer format.
SFT_TASK = "temporal-spatial free-form QA"
SFT_QUESTION = "What happens to the bowling ball?"
SFT_ANSWER = (
    "<think>At the start a <obj>bowling ball</obj><box>[142,96,198,150]</box>at<t>0.5</t>s "
    "leaves the bowler's hand and rolls down the lane. It hooks toward the head pin, and the "
    "<obj>pins</obj><box>[120,20,230,88]</box>at<t>5.5</t>s scatter when it arrives.</think>\n"
    "<answer>The bowling ball rolls down the lane and knocks the pins down.</answer>"
)
SFT_STEPS = 3
# The training numerics phase: full width, depth cut to 8 ViT blocks (global
# block 7 among them) and 2 decoder layers, so three models (kernel, plain
# bf16, float32) fit beside each other on the card.
NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS = 8, 2
# Gradients of the kernel tests: dout at 0.1 keeps them under ~1, where one
# bf16 ulp of reordered sums is within KERNEL_ATOL (at unit dout dk reaches
# ~8, where one ulp is 2^-5).
DOUT_SCALE = 0.1
# The GSPO slice (run_grpo_video.sh under --use_peft: LoRA rank 16, alpha 32
# on q_proj/v_proj; GSPOConfig defaults: G = 4, 768 completion tokens, beta
# 0.04, clip 5.0, lr 1e-6): one "temporal-spatial free-form QA" example in
# the RL data's format over the slice's 16 frames and one keyframe.
GSPO_EXAMPLE = {
    "task": "temporal-spatial free-form QA",
    "source": "STR_plm_rdcap",
    "video_path": "synthetic.mp4",
    "question": "What happens to the bowling ball after it leaves the bowler's hand?",
    "answer": "The bowling ball rolls down the lane and knocks the pins down.",
    "key_frames": [{"time": 3.0, "idx": 0, "path": "synthetic_kf_0.jpg"}],
    "key_items": {"0": {"bowling ball": [[0.42, 0.38, 0.59, 0.6]]}},
}
# Random weights give text that no reward scores, so row r of each group is
# scored as the r-th of these traces, of falling quality: the seven rewards
# differ within the group and the advantages are not zero.
GSPO_TRACES = (
    "<think>The <obj>bowling ball</obj><box>[141,96,198,151]</box>at<t>3.0</t>s rolls "
    "toward the pins and they fall at <t>6.5</t>s.</think>\n<answer>The bowling ball rolls "
    "down the lane and knocks the pins down.</answer>",
    "<think>A <obj>bowling ball</obj><box>[20,30,90,110]</box>at<t>1.0</t>s is thrown."
    "</think>\n<answer>The ball rolls down the lane.</answer>",
    "<think>Someone is bowling.</think>\n<answer>A man walks away.</answer>",
    "the pins <answer>nothing",
)
GSPO_MAX_STEPS = 2  # step_percent = (global_step + 1) / GSPO_MAX_STEPS
GSPO_CKPT_DIR = "checkpoints/chip_smoke_gspo"  # in the checkout (gitignored), removed after
# The kernels the GSPO step must launch (PEFT: vision frozen, so K1 and K2
# run their inference modes; the update's decoder runs K3 exact and K5).
GSPO_KERNELS = ("fused_window_attention", "window_attention", "flash_attention_gqa",
                "flash_attention_gqa_exact", "flash_attention_gqa_bwd_dq",
                "flash_attention_gqa_bwd_dkv")
# The full fine-tune branch: full width, depth cut so the trained copy, its
# gradients and AdamW state and the frozen reference fit beside the 7B base.
FT_VIT_DEPTH, FT_TEXT_LAYERS = 8, 4
FT_KERNELS = GSPO_KERNELS + ("fused_window_attention_exact", "window_attention_exact",
                             "fused_window_attention_bwd", "window_attention_bwd_dq",
                             "window_attention_bwd_dkv")
# Decode, graphed (the engine's default) against eager (decode_graph=False),
# on every decoding path: the tokens must be equal. The GSPO rollout is held
# at this many completion tokens a row; the early-stop check's EOS is the
# token the eager greedy run emits at step EARLY_STOP_STEP.
GSPO_CHECK_TOKENS = 128
EARLY_STOP_STEP = 5
# The SFT app (phase 15): a raw AVI of 32 frames of 252x336 at 16 fps and a
# PNG keyframe, written without an encoder, in the reference's media layout;
# a two-example STGR-CoT json (temporal-spatial with the keyframe, General
# video QA MCQ) read at 16 frames a video. The PEFT step is sft_main's
# default adapters (LoRA rank 16, alpha 32 on q_proj/v_proj) over the frozen
# 7B; sft_main runs at phase 10's cut of the model.
SFT_APP_DIR = "checkpoints/chip_smoke_sft_app"  # in the checkout (gitignored), removed after
SFT_APP_FRAMES, SFT_APP_FPS, SFT_APP_NFRAMES = 32, 16.0, 16
SFT_APP_EXAMPLES = [
    {"task": "temporal-spatial free-form QA", "source": "STR_plm_rdcap", "video_path": "clip.avi",
     "question": SFT_QUESTION,
     "reasoning_process": "A <obj>bowling ball</obj><box>[0.42,0.38,0.59,0.6]</box>at<t>1.0</t>s "
                          "rolls down the lane toward the pins.",
     "answer": "The bowling ball rolls down the lane and knocks the pins down.",
     "key_frames": [{"time": 1.0, "idx": 0, "path": "kf0.png"}]},
    {"task": "General video QA MCQ", "source": "videor1_mcq", "video_path": "clip.avi",
     "question": "What rolls down the lane? A. a bowling ball B. a cup C. a dog D. nothing",
     "reasoning_process": "A heavy round ball rolls toward the pins.", "answer": "A"},
]
SFT_APP_STEPS = 3
# PEFT: the frozen tower runs K1 and K2's inference modes, the decoder K3's
# exact mode and K5; no ViT backward, so K6 (and K1/K2's exact modes) never.
SFT_PEFT_KERNELS = GSPO_KERNELS[:2] + GSPO_KERNELS[3:]
SFT_PEFT_ABSENT = ("fused_window_attention_exact", "window_attention_exact",
                   "fused_window_attention_bwd", "window_attention_bwd_dq",
                   "window_attention_bwd_dkv")
# The eval path (phase 16): the reference's eval_all.sh (V-STAR inference,
# then the Qwen2.5-72B judge), TVGBench and the MCQ core with TTS, through
# the port's QwenVLEngine. A lossless AVI of 640x360 frames, 20 s at 1 fps:
# V-STAR and TVGBench take 16 of them as images, resized to 336x588 (24x42
# patches: K2 at W = 1008). A second one, 32 s at 2 fps, gives the
# VideoMME-style item its 64 frames at video_mme.yaml's pixels.
EVAL_DIR = "checkpoints/chip_smoke_eval"  # in the checkout (gitignored), removed after
EVAL_H, EVAL_W, EVAL_SECONDS, EVAL_FPS = 360, 640, 20, 1.0
MCQ_SECONDS, MCQ_FPS = 32, 2.0
# vstar.yaml's 2048 new tokens cut to this: random weights never emit EOS.
EVAL_MAX_TOKENS = 64
EVAL_ITEM_BATCH = 2
EVAL_KERNELS = SLICE_KERNELS
TVG_QUERIES = ("the bowling ball rolls down the lane", "the pins fall", "the bowler walks back")
MCQ_QUESTION = ("What rolls down the lane?\nA. a bowling ball\nB. a cup\nC. a dog\nD. nothing\n"
                "Answer with the option's letter.")
MCQ_OPTIONS = ["A. a bowling ball", "B. a cup", "C. a dog", "D. nothing"]
# One grounded trace over the MCQ item's frames (224x420 at 2 fps), as the
# model would write it: its evidence crops go to run_images_scorer_batch,
# which random weights never reach through the harness (they write no
# <answer>).
TTS_TRACE = ("<think>The <obj>bowling ball</obj><box>[100,60,220,160]</box>at<t>2.0</t>s "
             "rolls toward the <obj>pins</obj><box>[300,20,410,120]</box>at<t>10.5</t>s, and the "
             "<obj>lane</obj><box>[0,100,420,224]</box>at<t>20.0</t>s is empty after.</think>"
             "<answer>A</answer>")
# Random weights decode to ids above the byte range, which the ByteTokenizer
# drops, so a VQA answer may come out empty and would not reach the judge:
# 16b scores 16a's results file with each empty answer_vqa replaced by this.
JUDGE_FILL_ANSWER = "A bowling ball rolls down the lane."
# Phase 16c: the VideoMME, WorldSense and VideoMMMU harnesses over
# synthetic datasets in each benchmark's layout under BENCH_DIR (the tables
# written with pandas), each video a lossless AVI of 64 frames of 640x360
# (32 s at 2 fps: video_max_frames' 64) named <id>.mp4, as the dataloaders
# require (FFmpeg reads the container, whatever the suffix).
BENCH_DIR = f"{EVAL_DIR}/benchmarks"
BENCH_CONFIGS = {"videomme": "video_mme.yaml", "worldsense": "world_sense.yaml",
                 "videommmu": "video_mmmu.yaml"}
BENCH_MME = [  # (videoID, duration, domain, sub_category, task_type, question, options, answer)
    ("mme_a", "short", "Sports Competition", "Other Sports", "Object Recognition",
     "What rolls down the lane?", ["A. a bowling ball", "B. a cup", "C. a dog", "D. nothing"], "A"),
    ("mme_b", "medium", "Sports Competition", "Other Sports", "Counting Problem",
     "How many pins fall?", ["A. 3", "B. 5", "C. 7", "D. 10"], "D"),
    ("mme_c", "long", "Life Record", "Daily Life", "Temporal Reasoning",
     "What happens after the throw?", ["A. the pins fall", "B. it rains", "C. a song plays",
                                       "D. nothing"], "A")]
BENCH_MME_ASR = {"mme_a": "and here comes the throw, a strike!"}
BENCH_WS = [  # (video, question, candidates, answer, duration, domain, sub_category,
    #            task_domain, task_type, audio_class)
    ("ws_a", "What sound follows the throw?", ["A. a crash of pins", "B. a bell", "C. rain",
                                               "D. silence"], "A", "<1min", "Sports",
     "Other Sports", "Recognition", "Audio Recognition", ["Event"]),
    ("ws_b", "Who cheers?", ["A. the bowler", "B. the crowd", "C. nobody", "D. a child"], "B",
     "1-2min", "Sports", "Other Sports", "Understanding", "Human Interaction",
     ["Speech", "Event"]),
    ("ws_c", "How many throws are there?", ["A. one", "B. two", "C. three", "D. four"], "B",
     "2-4min", "Sports", "Other Sports", "Reasoning", "Action Counting", ["Event"])]
BENCH_WS_TRUNCATED = "ws_b"  # cut to its first 4096 bytes: no whole frame, a data error
BENCH_MMMU = {  # category -> (id, storage dir, question, options, answer, question_type)
    "Perception": ("test_Physics_1", "Science", "Which law does the lecture state first?",
                   ["Newton's first law", "Ohm's law", "Hooke's law", "Snell's law"], "A",
                   "multiple-choice"),
    "Comprehension": ("test_Math_2", "Science", "What is 17 + 25, as the slide computes it?",
                      [], "42", "open"),
    "Adaptation": ("test_Computer_Science_3", "Engineering",
                   "Which traversal visits the tree in the image in the order shown?",
                   ["A. preorder", "B. inorder", "C. postorder", "D. level order", "E. none"],
                   "B", "multiple-choice")}
BENCH_IMAGE_H, BENCH_IMAGE_W = 224, 336  # the Adaptation item's PNG
# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): bf16 tensor cores and HBM3. The bound of a kernel is the larger of
# its operations and its bytes at these rates.
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
# A spin queued before each timed call (~2 ms at the H100's clock), so the
# host has enqueued the call before its start event runs: the events then
# time the call's device work, not the wrapper's Python.
SPIN_CYCLES = 4_000_000


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> list[float]:
    """CUDA-event times of `fn`, each call behind a SPIN_CYCLES spin
    (torch.cuda._sleep). The spin came in with K4: without it the events
    also timed the wrapper's Python, so K1-K3 read 1-24% lower with it than
    their earlier times in PERF.md."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def agreement(out, ref, keep) -> dict:
    """`out` against `ref` over the kept rows (``keep`` None: all): max abs
    error, its bound (KERNEL_ATOL at the reference's scale), relative L2
    error, and whether both are within their bounds. Tuples of outputs (a
    backward's dq, dk, dv) are held element by element, with a tuple of
    masks; the worst element is reported."""
    if isinstance(out, (tuple, list)):
        keeps = keep if isinstance(keep, (tuple, list)) else (keep,) * len(out)
        parts = [agreement(o, r, k) for o, r, k in zip(out, ref, keeps)]
        worst = max(parts, key=lambda a: a["rel_l2"] / KERNEL_REL_L2
                    + a["max_abs_err"] / max(a["bound"], 1e-30))
        return {**worst, "ok": all(a["ok"] for a in parts),
                "max_abs_err": max(a["max_abs_err"] for a in parts)}
    out, ref = out.float(), ref.float()
    if keep is not None:
        out, ref = out[keep], ref[keep]
    err = (out - ref).abs().max().item()
    bound = KERNEL_ATOL * min(1.0, ref.abs().max().item())
    rel = ((out - ref).norm() / ref.norm()).item()
    return {"max_abs_err": err, "bound": bound, "rel_l2": rel,
            "ok": err <= bound and rel <= KERNEL_REL_L2}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(flops: float, moved: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations at
    the bf16 dense peak and the bytes (each input read once, each output
    written once) at the memory rate."""
    t_ops, t_bytes = 1e3 * flops / H100_BF16_FLOPS, 1e3 * moved / H100_HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def causal_pairs(pos, valid) -> int:
    """Visible (query, key) pairs of a causal mask: key t <= position and
    kv_valid[t], counted from this run's data."""
    seen = torch.cumsum(valid.long(), dim=1)  # (B, T) valid keys at or before t
    idx = pos.long().clamp(min=-1, max=valid.shape[1] - 1)
    got = torch.gather(seen, 1, idx.clamp(min=0))
    return int(torch.where(idx >= 0, got, 0).sum().item())


def segment_pairs(ids) -> int:
    """Visible (query, key) pairs of a segment mask (same nonzero id)."""
    g = ids.long()
    counts = torch.zeros((g.shape[0], int(g.max().item()) + 1), dtype=torch.long,
                         device=g.device).scatter_add_(1, g, torch.ones_like(g))
    return int((counts[:, 1:] ** 2).sum().item())


def compare(name, kernel_fn, plain_fn, keep, results, *, flops=0.0, moved=0,
            library_fn=None, case=None, plain_reps=20):
    """The kernel's agreement with its plain version over the kept rows,
    then times in turns (plain, kernel, kernel, plain), the bound from the
    work (`flops`, `moved` bytes) and, where one PyTorch call computes the
    same function, that call's time. The first case of a kernel is its
    main-path shape and gives its row in the JSON line."""
    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not all(torch.isfinite(o.float()).all() for o in outs):
        raise RuntimeError(f"{name}: non-finite kernel output")
    a = agreement(out, ref, keep)
    err = a["max_abs_err"]
    p1, k1, k2, p2 = (time_ms(f, reps) for f, reps in ((plain_fn, plain_reps), (kernel_fn, 20),
                                                       (kernel_fn, 20), (plain_fn, plain_reps)))
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    lib_ms = statistics.median(time_ms(library_fn)) if library_fn is not None else None
    b_ms, b_by = bound_ms(flops, moved)
    log("kernels", name=name, **({} if case is None else {"case": case}),
        shape=tuple(outs[0].shape), max_abs_err=err, bound=a["bound"],
        rel_l2=a["rel_l2"], max_rel_l2=KERNEL_REL_L2, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(b_ms, 4), bound_by=b_by,
        library_ms=None if lib_ms is None else round(lib_ms, 4))
    if not a["ok"]:
        raise RuntimeError(f"{name}: kernel vs plain {a}, max rel L2 {KERNEL_REL_L2}")
    prev = results.get(name)
    if prev is None:
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms}
    else:
        prev["max_abs_err"] = max(prev["max_abs_err"], err)
    return ref


def sdpa_masked(q, k, v, mask):
    """One PyTorch call computing masked attention (B, S, H, D) layout in,
    for the library time: scaled_dot_product_attention with a boolean mask
    (B, 1, S, T), GQA by enable_gqa."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          attn_mask=mask, enable_gqa=True)


def causal_mask(pos, valid):
    """(B, 1, S, T) boolean mask of the decoder's causal attention."""
    t = torch.arange(valid.shape[1], device=valid.device)
    return ((t[None, None, :] <= pos[:, :, None]) & (valid[:, None, :] != 0))[:, None]


def segment_mask(ids):
    g = ids.to(torch.int32)
    return ((g[:, :, None] == g[:, None, :]) & (g[:, None, :] != 0))[:, None]


# K1's and K6's packed window rows: 16 frames of 18x24 patches (W = 64,
# the slice and the SFT step; its case gives the kernels' rows) and of 18x26
# (W = 128, two windows a row).
WINDOW_ROW_GRIDS = ((18, 24), (18, 26))


def window_row_inputs(dev, gen, v, grid_hw):
    """The tower's packed window rows over N_FRAMES frames of grid_hw
    patches: segment ids (N, W), the rope tables cos, sin (N, W, D) float32
    and a random bf16 qkv projection (N, W, 3 * hidden)."""
    spec = compute_vision_spec([(1, *grid_hw)] * N_FRAMES, v)
    w = spec.win_w
    emb = np.concatenate([spec.padded_freqs, spec.padded_freqs], -1)
    cos = torch.from_numpy(np.cos(emb).reshape(-1, w, v.head_dim)).to(dev)
    sin = torch.from_numpy(np.sin(emb).reshape(-1, w, v.head_dim)).to(dev)
    ids = torch.from_numpy(spec.padded_gids.reshape(-1, w)).to(dev)
    qkv = torch.randn((ids.shape[0], w, 3 * v.hidden_size), generator=gen, device=dev)
    return ids, cos, sin, qkv.to(torch.bfloat16)


# K2's frames: the slice's 18x24 patches (W = 448, its K/V resident) and
# 32x32 (W = 1024, a 448x448 frame, streamed); the first gives K2's row.
K2_FRAME_GRIDS = ((18, 24), (32, 32))


def frame_inputs(dev, gen, v, grid_hw, scale=1.0):
    """Segment ids (N_FRAMES, W) of whole frames of grid_hw patches and
    random bf16 q, k, v and dout (dout at `scale`, 0 at pad rows)."""
    spec = compute_vision_spec([(1, *grid_hw)] * N_FRAMES, v)
    ids = torch.from_numpy(spec.padded_valid.reshape(-1, spec.frame_w).astype(np.int32)).to(dev)
    q, k, vv, do = (torch.randn((*ids.shape, v.num_heads, v.head_dim), generator=gen, device=dev)
                    for _ in range(4))
    do = (scale * do).to(torch.bfloat16)
    do[ids == 0] = 0  # the tower never reads a pad row
    return ids, q.to(torch.bfloat16), k.to(torch.bfloat16), vv.to(torch.bfloat16), do


def kernel_phase(dev, cfg, gen, batch_rows, t_total) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    v = cfg.vision
    results: dict = {}
    for grid_hw in WINDOW_ROW_GRIDS:
        ids, cos, sin, qkv = window_row_inputs(dev, gen, v, grid_hw)
        out_bytes = qkv.numel() // 3 * 2
        rq, rk, rv = wa._rope_qk(qkv, cos, sin, v.num_heads)
        seg = segment_mask(ids)
        ref = compare("fused_window_attention",
                      lambda: wa.fused_window_attention(qkv, cos, sin, ids, v.num_heads),
                      lambda: wa.fused_window_attention_torch(qkv, cos, sin, ids, v.num_heads),
                      ids != 0, results,
                      flops=4 * segment_pairs(ids) * v.num_heads * v.head_dim,
                      moved=nbytes(qkv, cos, sin, ids) + out_bytes,
                      library_fn=lambda: sdpa_masked(rq, rk, rv, seg), case=f"W = {ids.shape[1]}")
        if grid_hw == WINDOW_ROW_GRIDS[0]:  # fault: the rope on k left out
            raw_k = qkv.view(*rq.shape[:2], 3, *rq.shape[2:])[:, :, 1]
            planted("fused_window_attention", "rope on k left out",
                    wa.window_attention_torch(rq, raw_k, rv, ids).reshape(ref.shape), ref, ids != 0)
        del qkv, rq, rk, rv, seg, ref
    for grid_hw in K2_FRAME_GRIDS:
        frame_ids, q, k, vv, _ = frame_inputs(dev, gen, v, grid_hw)
        fseg = segment_mask(frame_ids)
        compare("window_attention",
                lambda: wa.window_attention(q, k, vv, frame_ids),
                lambda: wa.window_attention_torch(q, k, vv, frame_ids),
                frame_ids != 0, results,
                flops=4 * segment_pairs(frame_ids) * v.num_heads * v.head_dim,
                moved=nbytes(q, k, vv, frame_ids) + nbytes(q),
                library_fn=lambda: sdpa_masked(q, k, vv, fseg))
        del q, k, vv, fseg

    k3_prefill_case(dev, gen, cfg.text, batch_rows, t_total, "flash_attention_gqa", results)
    judge_prefill_case(dev, gen, results)
    decode_cases(dev, cfg, gen, results)
    serving_decode_cases(dev, gen, results)
    long_chunk_case(dev, cfg, gen, results)
    return results


def judge_prefill_case(dev, gen, results) -> None:
    """K3 at the judge's prefill (phase 13): JUDGE_PROMPT_ROWS tokens,
    left-padded into one batch, a cache of L + JUDGE_NEW_TOKENS slots,
    Qwen2.5-72B's 64/8 heads of 128 (a GQA group of 8)."""
    t = Qwen25VLConfig.from_hf_dict(QWEN25_72B_INSTRUCT_CONFIG).text
    B, S = len(JUDGE_PROMPT_ROWS), max(JUDGE_PROMPT_ROWS)
    T = S + JUDGE_NEW_TOKENS
    q = torch.randn((B, S, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    cache = torch.randn((2, 2, B, T, t.num_key_value_heads, t.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
    k, v = cache[0, 1], cache[1, 1]  # layer views of a stacked cache
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for b, n in enumerate(JUDGE_PROMPT_ROWS):
        valid[b, S - n:S] = 1
    mask = causal_mask(pos, valid)
    compare("flash_attention_gqa",
            lambda: fa.flash_attention_gqa(q, k, v, pos, valid),
            lambda: fa.flash_attention_gqa_torch(q, k, v, pos, valid),
            valid[:, :S] != 0, results, case="judge prefill, 64/8 heads",
            flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(q, k, v, pos, valid) + nbytes(q),
            library_fn=lambda: sdpa_masked(q, k, v, mask))
    del cache, mask


def _layer_views(dev, gen, cfg, B, T, written, dtype):
    """k/v as layer views of a stacked (2, 2, B, T, Hkv, D) cache in `dtype`:
    random values in the first `written` slots, NaN garbage after them (the
    kernel must never read it)."""
    t = cfg.text
    cache = torch.full((2, 2, B, T, t.num_key_value_heads, t.head_dim), float("nan"),
                       dtype=torch.bfloat16, device=dev)
    cache[:, :, :, :written] = torch.randn(cache[:, :, :, :written].shape, generator=gen,
                                           device=dev).to(torch.bfloat16)
    cache = cache.to(dtype)
    return cache[0, 1], cache[1, 1]


def decode_cases(dev, cfg, gen, results) -> None:
    """K4 vs its plain version on the long-context path's decode shapes. The
    plain version reads the written slots only: it multiplies masked values
    by 0, and the garbage tail is NaN. The first case is K4's main-path row
    (run (b)'s decode step)."""
    t = cfg.text
    # (B, S, T, last written position, stored dtype)
    for B, S, T, last, dtype in ((1, 1, 81920, 81887, torch.float8_e4m3fn),
                                 (1, 1, 32768, 32735, torch.bfloat16),
                                 (2, 4, 40000, 39990, torch.float8_e4m3fn)):
        k, v = _layer_views(dev, gen, cfg, B, T, last + 1, dtype)
        q = torch.randn((B, S, t.num_attention_heads, t.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        pos = torch.arange(last - S + 1, last + 1, dtype=torch.int32, device=dev).repeat(B, 1)
        valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
        valid[:, :last + 1] = 1
        if B > 1:
            valid[1, :1000] = 0  # a left-padded row
            pos[1, 0] = -1  # a pad query row, which sees nothing
        w = last + 1
        kb, vb = k[:, :w].to(torch.bfloat16), v[:, :w].to(torch.bfloat16)  # SDPA takes no fp8
        mask = causal_mask(pos, valid[:, :w])
        compare("decode_attention_gqa",
                lambda: da.decode_attention_gqa(q, k, v, pos, valid),
                lambda: da.decode_attention_gqa_torch(q, k[:, :w], v[:, :w], pos, valid[:, :w]),
                pos >= 0, results,
                flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
                moved=nbytes(q, k[:, :w], v[:, :w], pos, valid) + nbytes(q),
                library_fn=lambda: sdpa_masked(q, kb, vb, mask))
        del kb, vb
        if T == 81920:
            planted_faults(q, k[:, :w], v[:, :w], pos, valid[:, :w], T)
        del k, v
    torch.cuda.empty_cache()


# The serving cells' decode steps (portbench's `vstar.qwen25vl-7b` and
# `serve.qwen3vl-30b-a3b`), which run K4 below LONG_DECODE_T: (name, B, L,
# ring, Hq, Hkv, prompt lengths, ring columns written, holes). vstar: the
# 7B's 5 V-STAR queries of ~4.8-5.4k tokens, rows 1 and 2 on a shared prefix
# block with pad inside it, row 4 done early; the 30B: 8 unshared requests
# of ~2.6k tokens at a full batch.
SERVING_DECODE_CASES = (
    ("vstar step", 5, 5400, 512, 28, 4, (5400, 5310, 5022, 4821, 5398), (300, 300, 300, 300, 121),
     {1: ((3240, 3300),), 2: ((3160, 3300),)}),
    ("30B step", 8, 2620, 512, 32, 4, (2620, 2588, 2611, 2533, 2602, 2597, 2560, 2617),
     (200,) * 8, {}),
)


def serving_layout(dev, B, L, ring, written, prompts, holes):
    """A decode step's buffer as the engine lays it out: row b's prompt
    left-padded into [L - prompts[b], L), the ring [L, L + ring) written in
    its first written[b] columns, the holes[b] (start, end) left invalid,
    and every query at position T = L + ring, past every column
    (validity-only masking). Returns q_pos (B, 1) int64 and the validity
    (B, T) bool, the engine's dtypes."""
    T = L + ring
    valid = torch.zeros((B, T), dtype=torch.bool)
    for b in range(B):
        valid[b, L - prompts[b]:L + written[b]] = True
        for h0, h1 in holes.get(b, ()):
            valid[b, h0:h1] = False
    return torch.full((B, 1), T, dtype=torch.int64, device=dev), valid.to(dev)


def serving_decode_cases(dev, gen, results) -> None:
    """K4 vs its plain version at the serving cells' decode steps (bf16
    caches, NaN in every invalid slot, which K4 must never read; the plain
    version reads a finite copy), with the bound from the valid keys' bytes
    and SDPA on the same layer."""
    D = 128
    for name, B, L, ring, Hq, Hkv, prompts, written, holes in SERVING_DECODE_CASES:
        pos, valid = serving_layout(dev, B, L, ring, written, prompts, holes)
        T = L + ring
        clean = torch.randn((2, B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        cache = clean.clone()
        cache[:, ~valid] = float("nan")
        q = torch.randn((B, 1, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        n_valid = int(valid.sum().item())
        mask = causal_mask(pos, valid)
        compare("decode_attention_gqa",
                lambda: da.decode_attention_gqa(q, cache[0], cache[1], pos, valid),
                lambda: da.decode_attention_gqa_torch(q, clean[0], clean[1], pos, valid),
                None, results, case=f"{name} B={B} T={T} heads={Hq}/{Hkv}",
                flops=4 * causal_pairs(pos, valid) * Hq * D,
                moved=2 * n_valid * Hkv * D * 2 + nbytes(q, pos, valid, q),
                library_fn=lambda: sdpa_masked(q, clean[0], clean[1], mask))
        del cache, clean, mask
    torch.cuda.empty_cache()


def planted_faults(q, k, v, pos, valid, T) -> None:
    """The bound must reject a K4 that returns 0, drops one split of the key
    range, or drops the last (partial) key tile. The faulty outputs are the
    plain version with those keys masked, laid out as K4 splits a T-slot
    buffer: da.split_tiles of the K4_TILE_KEYS-key tiles of [0, w) over
    da._splits splits."""
    B, w, Hkv = k.shape[0], k.shape[1], k.shape[2]
    ref = da.decode_attention_gqa_torch(q, k, v, pos, valid)
    splits, tiles = da._splits(B, Hkv, T), -(-w // K4_TILE_KEYS)
    dropped = {"one split": da.split_tiles(tiles, splits)[splits // 2],
               "last tile": (tiles - 1, tiles)}
    faults = {"zero output": torch.zeros_like(ref)}
    for fault, (t0, t1) in dropped.items():
        masked = valid.clone()
        masked[:, t0 * K4_TILE_KEYS:t1 * K4_TILE_KEYS] = 0
        faults[f"{fault} dropped ({min(t1 * K4_TILE_KEYS, w) - t0 * K4_TILE_KEYS} of {w} keys)"] = (
            da.decode_attention_gqa_torch(q, k, v, pos, masked))
    for fault, out in faults.items():
        a = agreement(out, ref, pos >= 0)
        log("kernels", name="decode_attention_gqa", planted_fault=fault,
            max_abs_err=a["max_abs_err"], bound=a["bound"], rel_l2=a["rel_l2"],
            rejected=not a["ok"])
        if a["ok"]:
            raise RuntimeError(f"K4's bound does not reject a planted fault: {fault}")


def long_chunk_case(dev, cfg, gen, results) -> None:
    """K3 on the last prefill chunk of run (b): 8160 query rows at positions
    73728..81887 against an 81920-slot cache. Compared on 64 of the rows
    (the plain version at the whole chunk would need ~75 GB of f32 scores),
    passed with their positions to both versions; then timed at the whole
    chunk, with its bound (the causal pairs and bytes of the whole chunk)
    and SDPA on the whole chunk with its boolean mask."""
    t = cfg.text
    n, T = LONG_RUNS[1][1], LONG_RUNS[1][1] + LONG_NEW_TOKENS
    c0 = (n - 1) // LONG_CHUNK * LONG_CHUNK
    k, v = _layer_views(dev, gen, cfg, 1, T, T, torch.bfloat16)
    q = torch.randn((1, n - c0, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = torch.arange(c0, n, dtype=torch.int32, device=dev)[None]
    valid = torch.zeros((1, T), dtype=torch.int32, device=dev)
    valid[:, :n] = 1
    rows = torch.arange(0, n - c0, 128, device=dev)[:64]
    qs, ps = q[:, rows].contiguous(), pos[:, rows].contiguous()
    compare("flash_attention_gqa",
            lambda: fa.flash_attention_gqa(qs, k, v, ps, valid),
            lambda: fa.flash_attention_gqa_torch(qs, k, v, ps, valid),
            ps >= 0, results, case="long prefill chunk, 64 of its rows",
            flops=4 * causal_pairs(ps, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(qs, k, v, ps, valid, qs))
    full = statistics.median(time_ms(lambda: fa.flash_attention_gqa(q, k, v, pos, valid), reps=5))
    b_ms, b_by = bound_ms(4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
                          nbytes(q, k, v, pos, valid, q))
    mask = causal_mask(pos, valid)
    try:  # a yardstick only
        lib = statistics.median(time_ms(lambda: sdpa_masked(q, k, v, mask), reps=3, warmup=1))
    except torch.OutOfMemoryError:
        lib = None
    log("kernels", name="flash_attention_gqa", case="long prefill chunk", shape=tuple(q.shape),
        T=T, ms=round(full, 4), bound_ms=round(b_ms, 4), bound_by=b_by,
        library_ms=None if lib is None else round(lib, 4),
        tflops=round(4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim
                     / full / 1e9, 1))
    del k, v, q, mask
    torch.cuda.empty_cache()


def slice_frames(seed: int) -> list[np.ndarray]:
    """The slice's synthetic frames: 16 uint8 frames (T, C, H, W) per
    question, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(N_FRAMES, 3, FRAME_H, FRAME_W), dtype=np.uint8)
            for _ in QUESTIONS]


def frames_request(proc, cfg, frames, question: str) -> Request:
    """A grounded-QA request over ``frames`` (T, C, H, W), each an image:
    the processor's host patches (its ``pixel_patches`` path)."""
    frame_prompt = "".join(
        f"Frame {j + 1} at {round(j / FPS, 1)} second: "
        "<|vision_start|><|image_pad|><|vision_end|>\n" for j in range(len(frames))
    )
    prompt = proc.apply_chat_template([
        {"role": "system", "content": [{"type": "text", "text": SYSTEM_PROMPT}]},
        {"role": "user", "content": [{"type": "text", "text": frame_prompt},
                                     {"type": "text", "text": question}]},
    ], add_generation_prompt=True)
    x = proc(prompt, images=list(frames))
    return Request(input_ids=x.input_ids, pixel_patches=x.pixel_patches,
                   grid_thw=x.grid_thw, vision_token_id=cfg.image_token_id)


def make_requests(proc, cfg, seed: int) -> list[Request]:
    """One grounded-QA request per question, each over its own 16
    synthetic frames."""
    return [frames_request(proc, cfg, frames, question)
            for frames, question in zip(slice_frames(seed), QUESTIONS)]


def decode_run(engine, call):
    """``call()`` (a generate through ``engine``, or an entry point over
    it) with the engine's decode counters and the launch counts set to 0
    just before. Returns its result and the decode's numbers: ms per token
    (the whole decode stage, the capture included, over the steps that
    emitted a token), capture ms (a part of it), steps, wasted steps
    (enqueued after every row finished), the hand-written kernels'
    launches made inside the decode segments (``kernels.LAUNCHES``, which
    counts a replayed graph's kernels once per replay) in all and per step
    that ran, the prefill and vision seconds, and the scheduler's counters
    in the run (admissions, prefix blocks, segments, ring wraps, ...)."""
    engine.stage_seconds.clear()
    engine.decode_steps = engine.decode_steps_wasted = 0
    counters = collections.Counter(engine.counters)
    decode_launches: collections.Counter = collections.Counter()
    real = engine_module._GroupRun.segment

    def counted(run, *args, **kw):
        if run.engine is not engine:
            return real(run, *args, **kw)
        before = collections.Counter(kernels.LAUNCHES)
        out = real(run, *args, **kw)
        decode_launches.update(collections.Counter(kernels.LAUNCHES) - before)
        return out

    engine_module._GroupRun.segment = counted
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        out = call()
    finally:
        engine_module._GroupRun.segment = real
    st, ran = engine.stage_seconds, engine.decode_steps + engine.decode_steps_wasted
    counters = collections.Counter(engine.counters) - counters  # a missing key reads 0
    return out, {"ms_per_token": round(1e3 * st["decode"] / max(engine.decode_steps, 1), 3),
                 "capture_ms": round(1e3 * st["decode_capture"], 3),
                 "steps": engine.decode_steps, "wasted": engine.decode_steps_wasted,
                 "launches": dict(decode_launches),
                 "launches_per_step": round(sum(decode_launches.values()) / max(ran, 1), 3),
                 "prefill_s": round(st["prefill"], 4), "vision_s": round(st["vision"], 4),
                 "scheduler": counters}


def decode_pair(path: str, graph: dict, eager: dict, graph_tokens, eager_tokens) -> None:
    """A path's graphed decode held against its eager one: ms per token of
    both, the speedup, the capture, wasted steps, and the hand-written
    kernels' launches per step (the same for both: the tokens and the
    decode's kernel launch counts must be equal)."""
    same = graph_tokens == eager_tokens
    log("decode", path=path, graph_ms_per_token=graph["ms_per_token"],
        eager_ms_per_token=eager["ms_per_token"],
        speedup=round(eager["ms_per_token"] / max(graph["ms_per_token"], 1e-9), 3),
        capture_ms=graph["capture_ms"], steps=graph["steps"],
        wasted_steps={"graph": graph["wasted"], "eager": eager["wasted"]},
        kernel_launches_per_step=graph["launches_per_step"],
        decode_kernel_launches=graph["launches"], identical_tokens=same)
    if not same:
        raise RuntimeError(f"{path}: the graphed decode's tokens differ from the eager decode's")
    if graph["launches"] != eager["launches"] or graph["steps"] != eager["steps"]:
        raise RuntimeError(f"{path}: graphed and eager decode counted different launches or "
                           f"steps: {graph} vs {eager}")


def slice_phase(engine, reqs, sampling, names=SLICE_KERNELS) -> tuple[list[dict], dict, dict]:
    """The main path, through the entry points a user calls. Returns the
    outputs, the launch counts of ``names`` (each must be > 0) and the
    decode's numbers (``decode_run``)."""
    dev = engine.device
    engine.generate(reqs, SamplingParams(**{**vars(sampling), "max_tokens": 2}))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, decode = decode_run(engine, lambda: engine.generate(reqs, sampling))
    e2e = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in names}
    st = engine.stage_seconds
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log("slice", requests=len(reqs), prompt_tokens=[o["num_prompt_tokens"] for o in outs],
        new_tokens=[len(o["token_ids"]) for o in outs],
        vision_ms=round(1e3 * st["vision"], 3), prefill_ms=round(1e3 * st["prefill"], 3),
        decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
        e2e_s=round(e2e, 3), peak_mem_gib=round(peak, 3))
    log("slice", launches=launches)
    vocab = engine.cfg.text.vocab_size
    for o in outs:
        if not 1 <= len(o["token_ids"]) <= sampling.max_tokens:
            raise RuntimeError(f"bad output length {len(o['token_ids'])}")
        if not all(0 <= t < vocab for t in o["token_ids"]):
            raise RuntimeError("token id out of the vocabulary")
    if dev.type == "cuda" and not all(launches.values()):
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    return outs, launches, decode


def norm_sites(cfg) -> tuple[int, int]:
    """RMSNorm launches (``rms_norm``) a decoder forward and a tower pass of
    ``cfg`` make on the card: per layer 2 (input, post), 4 (Qwen3's q and k
    norms too) or 3 (Kimi-VL's latent norm too), and the final norm; 2 a
    block and the merger's in an RMSNorm tower (Qwen2.5-VL), none in a
    LayerNorm one."""
    t = cfg.text
    per_layer = 3 if hasattr(t, "kv_lora_rank") else 2 + 2 * t.use_qk_norm
    rms_tower = getattr(cfg.vision, "norm_type", "layernorm") == "rmsnorm"
    return per_layer * t.num_hidden_layers + 1, 2 * cfg.vision.depth + 1 if rms_tower else 0


def norm_launches(tag: str, cfg, run: dict, phase: str) -> int:
    """The RMSNorm kernel's launches in a ``decode_run`` of ``cfg`` (the
    counts set to 0 just before), held to the main path's: a forward's
    norm sites in every prefill forward and every decode step that ran, the
    tower's in every tower pass, and a forward's in every step of the
    decode segments alone (replays counted). Returns the whole count."""
    forward, tower = norm_sites(cfg)
    sched, ran = run["scheduler"], run["steps"] + run["wasted"]
    want = forward * (sched["prefills"] + ran) + tower * sched["tower_passes"]
    got, decode = kernels.LAUNCHES["rms_norm"], run["launches"].get("rms_norm", 0)
    log(phase, run=tag, rms_norm_launches=got, want=want, decode_launches=decode,
        want_decode=forward * ran, norms_a_forward=forward, norms_a_tower_pass=tower,
        prefills=sched["prefills"], decode_steps=ran, tower_passes=sched["tower_passes"])
    if got != want or decode != forward * ran or ran == 0:
        raise RuntimeError(f"{tag}: rms_norm launched {got} times ({decode} in the decode "
                           f"segments), want {want} ({forward * ran})")
    return got


def eager_pair(path: str, params, cfg, reqs, sampling, graph_outs, graph: dict,
               **engine_kw) -> list[dict]:
    """The same requests through an engine that decodes eagerly, held
    against the graphed run's outputs and numbers (``decode_pair``)."""
    engine = InferenceEngine(params, cfg, decode_graph=False, **engine_kw)
    outs, eager = decode_run(engine, lambda: engine.generate(reqs, sampling))
    decode_pair(path, graph, eager, [o["token_ids"] for o in graph_outs],
                [o["token_ids"] for o in outs])
    return outs


def early_stop_check(params, cfg, req) -> None:
    """A copy of the config whose EOS is the token that an eager greedy run
    emits at step EARLY_STOP_STEP: the eager and the graphed decode must stop
    at the same token, with at most DONE_LAG - 1 steps run after it."""
    sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=MAX_TOKENS)
    first = InferenceEngine(params, cfg, decode_graph=False).generate([req], sampling)[0]
    eos = first["token_ids"][EARLY_STOP_STEP]
    stop_cfg = dataclasses.replace(cfg, eos_token_id=eos)
    runs = {}
    for graphed in (True, False):
        engine = InferenceEngine(params, stop_cfg, decode_graph=graphed)
        runs[graphed] = decode_run(engine, lambda: engine.generate([req], sampling)[0])
    (g_out, graph), (e_out, eager) = runs[True], runs[False]
    log("decode", path="early stop", eos=eos, stopped_after=len(g_out["token_ids"]))
    decode_pair("early stop", graph, eager, g_out["token_ids"], e_out["token_ids"])
    if g_out["token_ids"][-1] != eos or len(g_out["token_ids"]) > EARLY_STOP_STEP + 1:
        raise RuntimeError(f"the early-stop run did not stop at its EOS {eos}: {g_out}")
    if graph["wasted"] > DONE_LAG - 1:
        raise RuntimeError(f"{graph['wasted']} wasted steps: more than the {DONE_LAG - 1} "
                           "the done flags' lag allows")


def long_request(n: int) -> Request:
    """A text-only prompt of n tokens, made as the JAX bench's long-context
    leg makes it (ids 100 + i % 500, ByteTokenizer byte ids)."""
    return Request(input_ids=[100 + (i % 500) for i in range(n)])


def long_sampling(seed: int) -> SamplingParams:
    """The JAX bench's long-context leg: greedy, repetition penalty 1.05."""
    return SamplingParams(temperature=0.0, repetition_penalty=1.05,
                          max_tokens=LONG_NEW_TOKENS, seed=seed)


def long_run(engine, n, sampling) -> tuple[list[int], dict, dict]:
    """One long-context request through InferenceEngine.generate: stage
    times, peak memory and launch counts; K3 and K4 must both launch.
    Returns the tokens, the launch counts and the decode's numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, decode = decode_run(engine, lambda: engine.generate([long_request(n)], sampling)[0])
    e2e = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in LONG_KERNELS}
    st = engine.stage_seconds
    log("longctx", prompt_tokens=out["num_prompt_tokens"], cache=str(engine.cache_dtype),
        T=n + sampling.max_tokens, new_tokens=len(out["token_ids"]),
        decode_graph=engine.decode_graph, prefill_ms=round(1e3 * st["prefill"], 3),
        prefill_tok_per_s=round(n / st["prefill"], 1),
        decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
        e2e_s=round(e2e, 3), peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    (group,) = engine.groups
    log("longctx", launches=launches, slots=group["slots"],
        arena_gib=round(group["arena_bytes"] / 2**30, 3),
        prefills=decode["scheduler"]["prefills"])
    chunks = -(-n // engine.long_prefill_chunk) if n >= engine.long_prefill_threshold else 1
    if group["slots"] != 1 or decode["scheduler"]["prefills"] != chunks:
        raise RuntimeError(f"the long request did not prefill its chunks into a one-slot arena: "
                           f"{group}, {decode['scheduler']}")
    vocab = engine.cfg.text.vocab_size
    if not 1 <= len(out["token_ids"]) <= sampling.max_tokens:
        raise RuntimeError(f"bad output length {len(out['token_ids'])}")
    if not all(0 <= t < vocab for t in out["token_ids"]):
        raise RuntimeError("token id out of the vocabulary")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the long-context path never launched: {launches}")
    return out["token_ids"], launches, decode


def long_phase(params, cfg, seed) -> tuple[dict, dict, dict]:
    """Runs (a) and (b), after a warm-up at (a)'s size. Returns each run's
    tokens, launch counts and decode numbers."""
    sampling = long_sampling(seed)
    engines = {name: InferenceEngine(params, cfg, cache_dtype=dtype, long_prefill_chunk=LONG_CHUNK)
               for name, _, dtype in LONG_RUNS}
    engines["a"].generate([long_request(LONG_RUNS[0][1])],
                          dataclasses.replace(sampling, max_tokens=2))
    tokens, launches, decode = {}, {}, {}
    t0 = time.perf_counter()
    for name, n, _ in LONG_RUNS:
        tokens[name], launches[name], decode[name] = long_run(engines[name], n, sampling)
    log("longctx", runs_seconds=round(time.perf_counter() - t0, 3),
        first_token_ids={k: v[:8] for k, v in tokens.items()})
    torch.cuda.empty_cache()
    return tokens, launches, decode


def _agreement(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.double().flatten(), b.double().flatten()
    rel = ((a - b).norm() / b.norm()).item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    return rel, cos


def _cast(tree, dtype):
    """The param dict in ``dtype``; an int4 weight is dequantized."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    if isinstance(tree, i4.Int4Linear):
        return i4.dequantize(tree, dtype)
    return tree.detach().to(dtype)


def _vision_and_logits(params, cfg, reqs, impl):
    """Vision embeddings of every request and the last-position prefill
    logits of each row, laid out as InferenceEngine.generate lays out its
    prefill: one tower pass per request, the rows left-padded to L and
    merged by index, a cache of L + MAX_TOKENS slots."""
    dev = params["text"]["embed_tokens"].device
    L = max(len(r.input_ids) for r in reqs)
    ids, mask, position_ids, _ = left_padded_rows(cfg, reqs, L)
    attn_valid = torch.zeros((len(reqs), L + MAX_TOKENS), dtype=torch.bool, device=dev)
    attn_valid[:, :L] = torch.from_numpy(mask).to(dev)
    with torch.inference_mode():
        vis = [encode_vision(params, cfg, torch.from_numpy(r.pixel_patches).to(dev), r.grid_thw,
                             impl=impl) for r in reqs]
        offsets = np.cumsum([0] + [x.shape[0] for x in vis[:-1]]).tolist()
        vis = torch.cat(vis)
        row_index = build_vision_row_index(ids, cfg.image_token_id, offsets)
        embeds = merge_vision_embeddings_by_index(
            embed_tokens(params, torch.from_numpy(ids).to(dev)), vis,
            torch.from_numpy(row_index).to(dev))
        hidden, _ = text_forward(
            params["text"], cfg.text, embeds, torch.from_numpy(position_ids).to(dev),
            attn_valid=attn_valid, attn_impl=impl,
            cache=init_kv_cache(cfg.text, len(reqs), L + MAX_TOKENS, dtype=cfg.dtype,
                                device=dev),
        )
        logits = logits_from_hidden(params["text"], hidden[:, -1], impl)
    return vis.float(), logits.float()


def numerics_phase(params, cfg, reqs) -> None:
    """The slice's numerics at full width, all requests. Two bf16 paths that
    round differently drift apart by a few percent over 60 random-init
    layers, so the kernel path is not held to the plain bf16 path. Both are
    held to a float32 reference (the same weights in f32, plain versions):
    the kernel path must be as close to it as the plain bf16 path is, within
    SLICE_REL_RATIO."""
    kernel = _vision_and_logits(params, cfg, reqs, "auto")
    plain = _vision_and_logits(params, cfg, reqs, "torch")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = _vision_and_logits(_cast(params, torch.float32), cfg32, reqs, "torch")
    torch.cuda.empty_cache()
    for i, what in enumerate(("vision", "logits")):
        rel_k, cos_k = _agreement(kernel[i], ref[i])
        rel_p, cos_p = _agreement(plain[i], ref[i])
        rel_kp, cos_kp = _agreement(kernel[i], plain[i])
        log("numerics", what=what, kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
            plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, kernel_vs_plain_rel=rel_kp,
            kernel_vs_plain_cos=cos_kp, max_ratio=SLICE_REL_RATIO)
        if not (torch.isfinite(kernel[i]).all() and rel_k <= SLICE_REL_RATIO * rel_p):
            raise RuntimeError(f"{what}: the kernel path is further from float32 than the "
                               f"plain bf16 path ({rel_k} vs {rel_p})")


def long_numerics_phase(params, cfg) -> None:
    """K4 inside the full path: run (b)'s request prefilled by the kernel
    path into a fresh fp8 cache, then one decode step's text_forward with
    attn_impl "auto" (K4) and "torch" (its plain version), each on a copy of
    the cache. A decode step runs no other kernel, so only K4 differs. Both
    are also compared with the same step in float32 (the same weights in
    f32, plain versions, the same fp8 cache)."""
    _, n, dtype = LONG_RUNS[1]
    T = n + LONG_NEW_TOKENS
    dev = params["text"]["embed_tokens"].device
    _, _, position_ids, next_pos = left_padded_rows(cfg, [long_request(n)], n)
    ids = torch.tensor([long_request(n).input_ids], device=dev)
    attn_valid = torch.zeros((1, T), dtype=torch.bool, device=dev)
    attn_valid[:, :n + 1] = True
    with torch.inference_mode():
        cache = init_kv_cache(cfg.text, 1, T, dtype=dtype, device=dev)
        embeds, position_ids = embed_tokens(params, ids), torch.from_numpy(position_ids).to(dev)
        for c0 in range(0, n, LONG_CHUNK):  # the prefill in chunks, as the engine runs it
            hidden, _ = text_forward(params["text"], cfg.text, embeds[:, c0:c0 + LONG_CHUNK],
                                     position_ids[:, :, c0:c0 + LONG_CHUNK],
                                     attn_valid=attn_valid, cache=cache, cache_offset=c0)
        token = logits_from_hidden(params["text"], hidden[:, -1]).argmax(-1)
        logits = {}
        for name, weights, impl in (("kernel", params, "auto"), ("plain", params, "torch"),
                                    ("f32", {"text": _cast(params["text"], torch.float32)},
                                     "torch")):
            step_cache = {key: x.clone() for key, x in cache.items()}
            h, _ = text_forward(
                weights["text"], cfg.text, embed_tokens(weights, token[:, None]),
                torch.from_numpy(next_pos).to(dev)[None, :, None].expand(3, 1, 1),
                seq_positions=torch.full((1, 1), n, device=dev), attn_valid=attn_valid,
                cache=step_cache, cache_offset=n, attn_impl=impl)
            logits[name] = logits_from_hidden(weights["text"], h[:, 0])
            del step_cache, weights
    rel, cos = _agreement(logits["kernel"], logits["plain"])
    rel_k, _ = _agreement(logits["kernel"], logits["f32"])
    rel_p, _ = _agreement(logits["plain"], logits["f32"])
    log("numerics", what="long-context decode step logits (fp8 cache, T=81920)",
        kernel_vs_plain_rel=rel, kernel_vs_plain_cos=cos, max_rel=LONG_LOGITS_REL,
        min_cos=LONG_LOGITS_COS, kernel_vs_f32_rel=rel_k, plain_vs_f32_rel=rel_p,
        max_ratio=SLICE_REL_RATIO)
    if not (torch.isfinite(logits["kernel"]).all() and rel <= LONG_LOGITS_REL
            and cos >= LONG_LOGITS_COS and rel_k <= SLICE_REL_RATIO * rel_p):
        raise RuntimeError(f"long-context decode: K4 vs plain logits rel {rel}, cos {cos}; "
                           f"vs float32 {rel_k} (plain {rel_p})")
    del cache
    torch.cuda.empty_cache()


# ---- training ---------------------------------------------------------------


def sft_batch(proc, cfg, seed: int, frame_hw=(FRAME_H, FRAME_W)) -> dict:
    """The SFT slice's batch: one example over 16 synthetic frames of
    ``frame_hw`` through the port's collate and pack (ByteTokenizer, labels
    masked)."""
    frames = np.random.default_rng(seed + 1).integers(
        0, 256, size=(N_FRAMES, 3, *frame_hw), dtype=np.uint8)
    messages = [
        {"role": "system", "content": [{"type": "text", "text": SFT_SYSTEM_PROMPT[SFT_TASK]}]},
        {"role": "user", "content": [{"type": "video", "video": "synthetic"},
                                     {"type": "text", "text": SFT_QUESTION}]},
        {"role": "assistant", "content": [{"type": "text", "text": SFT_ANSWER}]},
    ]
    return pack_sft_batch([collate_sft_frames(messages, list(frames), FPS, proc, cfg)], cfg)


def sdpa_fwd_bwd(q, k, v, dout, **kw):
    """One PyTorch call's forward and backward of the same attention, for
    the library time of a backward kernel: (B, S, H, D) layout in."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw).backward(dout.transpose(1, 2))


def training_kernel_phase(dev, cfg, gen, batch, results) -> None:
    """The training kernels against their plain versions at the SFT slice's
    shapes: the exact forwards of K1-K3 (out and lse), K5 (dq; dk, dv) and
    K6 (fused dqkv; window dq; dk, dv). Faults planted in K5's dq and dk/dv
    and in K6's fused and window dk/dv outputs must fail the bound."""
    v, t = cfg.vision, cfg.text
    H, D = v.num_heads, v.head_dim

    def bf16(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    for grid_hw in WINDOW_ROW_GRIDS:
        ids, cos, sin, qkv = window_row_inputs(dev, gen, v, grid_hw)
        do = bf16(*qkv.shape[:2], v.hidden_size, scale=DOUT_SCALE)
        do[ids == 0] = 0  # the tower never reads a pad row
        pairs = segment_pairs(ids) * H * D
        rq, rk, rv = wa._rope_qk(qkv, cos, sin, H)
        seg = segment_mask(ids)
        case = f"W = {ids.shape[1]}"
        compare("fused_window_attention_exact",
                lambda: wa.fused_window_attention_exact(qkv, cos, sin, ids, H),
                lambda: wa.fused_window_attention_exact_torch(qkv, cos, sin, ids, H),
                ids != 0, results, flops=4 * pairs,
                moved=nbytes(qkv, cos, sin, ids) + nbytes(do),  # out has dout's shape
                library_fn=lambda: sdpa_masked(rq, rk, rv, seg), case=case)
        ref = compare("fused_window_attention_bwd",
                      lambda: wa.fused_window_attention_bwd(qkv, cos, sin, ids, H, do),
                      lambda: wa.fused_window_attention_bwd_torch(qkv, cos, sin, ids, H, do),
                      None, results, flops=10 * pairs, moved=nbytes(qkv, cos, sin, ids, do, qkv),
                      library_fn=lambda: sdpa_fwd_bwd(rq, rk, rv, do.view(*rq.shape), attn_mask=seg),
                      case=case)
        if grid_hw == WINDOW_ROW_GRIDS[0]:  # fault: the rope transpose left out of dq and dk
            no_rope = torch.stack(wa._window_bwd_f32(rq, rk, rv, ids, do.view(*rq.shape)), dim=2)
            planted("fused_window_attention_bwd", "rope transpose left out",
                    no_rope.reshape(qkv.shape).to(qkv.dtype), ref, None)
            del no_rope
        del qkv, do, rq, rk, rv, seg, ref

    slice_frames = None
    for grid_hw in K2_FRAME_GRIDS:
        frame_ids, q, k, vv, do = case = frame_inputs(dev, gen, v, grid_hw, DOUT_SCALE)
        if slice_frames is None:  # the slice's frames, for K6 below
            slice_frames = case
        fseg = segment_mask(frame_ids)
        valid_rows = (frame_ids != 0)[:, None, :].expand(-1, H, -1)
        compare("window_attention_exact",
                lambda: wa.window_attention_exact(q, k, vv, frame_ids),
                lambda: wa.window_attention_exact_torch(q, k, vv, frame_ids),
                (frame_ids != 0, valid_rows), results,
                flops=4 * segment_pairs(frame_ids) * H * D,
                moved=nbytes(q, k, vv, frame_ids, q) + 4 * q.numel() // D,
                library_fn=lambda: sdpa_masked(q, k, vv, fseg))
        del case, q, k, vv, do, fseg
    frame_ids, q, k, vv, do = slice_frames
    del slice_frames
    fseg = segment_mask(frame_ids)
    fpairs = segment_pairs(frame_ids) * H * D
    out, lse = wa.window_attention_exact(q, k, vv, frame_ids)
    ops = wa.bwd_operands(q, k, vv, frame_ids, out, lse, do)
    ins = nbytes(*ops)
    compare("window_attention_bwd_dq", lambda: wa.window_attention_bwd_dq(ops),
            lambda: wa.window_attention_bwd_torch(q, k, vv, frame_ids, do)[0],
            None, results, flops=6 * fpairs, moved=ins + nbytes(q),
            library_fn=lambda: sdpa_fwd_bwd(q, k, vv, do, attn_mask=fseg))
    ref = compare("window_attention_bwd_dkv", lambda: wa.window_attention_bwd_dkv(ops),
                  lambda: wa.window_attention_bwd_torch(q, k, vv, frame_ids, do)[1:],
                  None, results, flops=8 * fpairs, moved=ins + 2 * nbytes(q),
                  library_fn=lambda: sdpa_fwd_bwd(q, k, vv, do, attn_mask=fseg))
    # fault: frame 0's segment mask ignored (its padded tail seen as keys)
    ignored = frame_ids.clone()
    ignored[0] = 1
    planted("window_attention_bwd_dkv", "frame 0's segment mask ignored",
            wa.window_attention_bwd_torch(q, k, vv, ignored, do)[1:], ref, None)
    del q, k, vv, do, out, lse, ops, ref, ignored

    # the decoder at the packed example's length, right-padded keys
    L = batch["input_ids"].shape[1]
    valid = torch.from_numpy(batch["attn_valid"].astype(np.int32)).to(dev)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None].contiguous()
    q = bf16(1, L, t.num_attention_heads, t.head_dim)
    k, vv = (bf16(1, L, t.num_key_value_heads, t.head_dim) for _ in range(2))
    do = bf16(1, L, t.num_attention_heads, t.head_dim, scale=DOUT_SCALE)
    cpairs = causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim
    mask = causal_mask(pos, valid)
    rows = valid != 0
    compare("flash_attention_gqa_exact",
            lambda: fa.flash_attention_gqa_exact(q, k, vv, pos, valid),
            lambda: fa.flash_attention_gqa_exact_torch(q, k, vv, pos, valid),
            (rows, rows[:, None, :].expand(-1, t.num_attention_heads, -1)), results,
            flops=4 * cpairs, moved=nbytes(q, k, vv, pos, valid, q) + 4 * q.numel() // t.head_dim,
            library_fn=lambda: sdpa_masked(q, k, vv, mask))
    exact_group8_case(dev, gen, results)
    out, lse = fa.flash_attention_gqa_exact(q, k, vv, pos, valid)
    ops = fa.bwd_operands(q, k, vv, pos, valid, out, lse, do)
    ins = nbytes(*ops)
    lib = lambda: sdpa_fwd_bwd(q, k, vv, do, is_causal=True)  # noqa: E731
    ref = compare("flash_attention_gqa_bwd_dq", lambda: fa.flash_attention_gqa_bwd_dq(ops),
                  lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[0],
                  None, results, flops=6 * cpairs, moved=ins + nbytes(q), library_fn=lib)
    # fault: dq from delta = 0 (out = 0 gives delta = rowsum(dout * out) = 0)
    planted("flash_attention_gqa_bwd_dq", "dq from delta = 0",
            fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, torch.zeros_like(out), lse,
                                             do)[0], ref, None)
    ref = compare("flash_attention_gqa_bwd_dkv", lambda: fa.flash_attention_gqa_bwd_dkv(ops),
                  lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[1:],
                  None, results, flops=8 * cpairs, moved=ins + nbytes(k, vv), library_fn=lib)
    # fault: dk/dv summed over 6 of the 7 heads of each group
    G = t.num_attention_heads // t.num_key_value_heads
    dropped = do.clone()
    dropped[:, :, G - 1::G] = 0
    fault = fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, dropped)[1:]
    planted("flash_attention_gqa_bwd_dkv", f"dk/dv over {G - 1} of {G} group heads", fault, ref,
            None)
    del q, k, vv, do, out, lse, ops, dropped, fault
    torch.cuda.empty_cache()


def exact_group8_case(dev, gen, results) -> None:
    """K3's exact mode (out and lse) at a GQA group of 8, Qwen2.5-72B's
    64/8 heads, on 1024 tokens with the last 40 keys right-padded."""
    Hq, Hkv, D, L = 64, 8, 128, 1024
    q = torch.randn((1, L, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, L, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None]
    valid = torch.ones((1, L), dtype=torch.int32, device=dev)
    valid[:, L - 40:] = 0
    rows = valid != 0
    mask = causal_mask(pos, valid)
    compare("flash_attention_gqa_exact",
            lambda: fa.flash_attention_gqa_exact(q, k, v, pos, valid),
            lambda: fa.flash_attention_gqa_exact_torch(q, k, v, pos, valid),
            (rows, rows[:, None, :].expand(-1, Hq, -1)), results, case="64/8 heads",
            flops=4 * causal_pairs(pos, valid) * Hq * D,
            moved=nbytes(q, k, v, pos, valid, q) + 4 * q.numel() // D,
            library_fn=lambda: sdpa_masked(q, k, v, mask))
    del q, k, v, mask


def planted(name, fault, out, ref, keep) -> None:
    """A planted fault's output must fail the kernel bound."""
    a = agreement(out, ref, keep)
    log("kernels", name=name, planted_fault=fault, max_abs_err=a["max_abs_err"], bound=a["bound"],
        rel_l2=a["rel_l2"], rejected=not a["ok"])
    if a["ok"]:
        raise RuntimeError(f"{name}: the bound does not reject a planted fault: {fault}")


DEVICE_CLASSES = (("attention kernels (csrc/)", ("o3v",)),
                  ("matmul", ("gemm", "cutlass", "nvjet", "xmma", "sm90_")),
                  ("optimizer", ("adam",)))


def device_breakdown(prof, wall_s: float) -> dict:
    """Device time of a profiled run by kernel class, the busy share of the
    wall time (kernel time summed, so overlap would count twice), and the
    attention kernels' time by kernel function."""
    by_class = {name: 0.0 for name, _ in DEVICE_CLASSES}
    by_class["other"] = 0.0
    attention: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        key = evt.key.lower()
        cls = next((name for name, marks in DEVICE_CLASSES if any(m in key for m in marks)),
                   "other")
        by_class[cls] += ms
        if cls == DEVICE_CLASSES[0][0]:
            fn = re.search(r"(\w+_kernel(?:<[^>]*>)?)", evt.key)
            name = fn.group(1) if fn else evt.key[:48]
            attention[name] = attention.get(name, 0.0) + ms
    busy = sum(by_class.values())
    return {"device_ms": {k: round(x, 3) for k, x in by_class.items()},
            "busy_share": round(busy / (1e3 * wall_s), 4) if wall_s else None,
            "attention_ms": {k: round(x, 3) for k, x in sorted(attention.items())}}


def sft_phase(params, cfg, batch) -> dict:
    """The SFT slice through make_train_step: SFT_STEPS full fine-tune steps
    of Qwen2.5-VL-7B (AdamW at the SFTConfig defaults, remat on). Step 1's
    loss and gradient norm are first computed without the update, under the
    profiler (device time by kernel class), and must come out identical in
    the step. Returns the launch counts of the training kernels over the
    steps; each must be > 0."""
    train_cfg = SFTConfig()
    opt = make_optimizer(train_cfg)
    P.trainable(params)
    state = opt.init(params)
    step = make_train_step(cfg, train_cfg, opt)
    log("sft", tokens=int(batch["attn_valid"].sum()), padded_len=batch["input_ids"].shape[1],
        target_tokens=int((batch["labels"][:, 1:] != -100).sum()),
        patches=batch["pixel_patches"].shape[0], params=P.count(params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        first = loss_and_grads(params, cfg, train_cfg, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log("sft", profiled="forward+backward of step 1 without its update", seconds=round(wall, 3),
        **device_breakdown(prof, wall))
    del prof
    for x in P.leaves(params):
        x.grad = None
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    metrics = []
    for i in range(SFT_STEPS):
        t0 = time.perf_counter()
        _, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        m = {k: float(x) for k, x in m.items()}
        metrics.append(m)
        log("sft", step=i + 1, seconds=round(time.perf_counter() - t0, 3), loss=m["loss"],
            grad_norm=m["grad_norm"], num_target_tokens=int(m["num_target_tokens"]))
    launches = {name: kernels.LAUNCHES[name] for name in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("sft", launches_per_step={k: n / SFT_STEPS for k, n in launches.items()},
        peak_mem_gib=round(peak, 3))
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        raise RuntimeError(f"non-finite loss or gradient norm: {metrics}")
    same = (float(first["loss"]) == metrics[0]["loss"]
            and float(first["grad_norm"]) == metrics[0]["grad_norm"])
    log("sft", step1_repeat_loss=float(first["loss"]), step1_repeat_grad_norm=float(first["grad_norm"]),
        identical=same)
    if not same:
        raise RuntimeError("step 1 repeated from the same params and state gave another result")
    if not all(launches.values()):
        raise RuntimeError(f"a training kernel never launched: {launches}")
    return launches


def _grad_groups(weights) -> dict:
    """The trainable leaves by group: the ViT (its merger included), the
    deepstack mergers (Qwen3-VL) or Aria's projector, the decoder layers
    (and the final norm), the embedding and the lm_head."""
    text = weights["text"]
    visual = {k: v for k, v in weights["visual"].items() if k != "deepstack"}
    groups = {"vit": P.leaves(visual)}
    if weights["visual"].get("deepstack"):
        groups["deepstack"] = P.leaves(weights["visual"]["deepstack"])
    if "projector" in weights:
        groups["projector"] = P.leaves(weights["projector"])
    return {**groups,
            "decoder": P.leaves(text["layers"]) + [text["final_norm"]],
            "embed_lm_head": [text["embed_tokens"], text["lm_head"]]}


def _loss_and_grad_copies(weights, cfg, batch, impl) -> tuple[float, dict]:
    """Loss and a copy of every gradient, by group; the leaves' grads are
    then cleared for the next path."""
    m = loss_and_grads(weights, cfg, SFTConfig(), batch, attn_impl=impl)
    grads = {g: [x.grad.clone() for x in xs] for g, xs in _grad_groups(weights).items()}
    for x in P.leaves(weights):
        x.grad = None
    return float(m["loss"]), grads


def _agreement_sums(grads, ref, chunk: int = 1 << 26) -> tuple[float, float]:
    """Relative L2 error and cosine of a list of gradients against a
    reference list, summed in float64 over chunks of the flattened leaves
    (the embedding's gradient alone has 545M elements)."""
    diff = ref_sq = dot = own_sq = 0.0
    for a, b in zip(grads, ref):
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), chunk):
            x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
            diff += ((x - y) ** 2).sum().item()
            ref_sq += (y * y).sum().item()
            dot += (x * y).sum().item()
            own_sq += (x * x).sum().item()
    return float(np.sqrt(diff / ref_sq)), dot / float(np.sqrt(ref_sq * own_sq))


def train_numerics_phase(params, cfg, batch, vit_depth=NUMERICS_VIT_DEPTH,
                         text_layers=NUMERICS_TEXT_LAYERS, tag="train_numerics") -> None:
    """Training numerics at full width, depth cut to vit_depth ViT blocks
    (the deepstack taps among them) and text_layers decoder layers: the
    loss and gradients of the kernel path and of the plain bf16 path
    (impl="torch"), each against a float32 plain reference on the same
    weights. Per group, the kernel path may be at most SLICE_REL_RATIO
    further from float32 than the plain path."""
    small_cfg = _cut_cfg(cfg, vit_depth, text_layers)
    small = _sub(params, vit_depth, text_layers, cfg.vision)
    loss_k, grads_k = _loss_and_grad_copies(small, small_cfg, batch, "auto")
    loss_p, grads_p = _loss_and_grad_copies(small, small_cfg, batch, "torch")
    ref = P.trainable(_cast(small, torch.float32))
    cfg32 = dataclasses.replace(small_cfg, dtype=torch.float32)
    m = loss_and_grads(ref, cfg32, SFTConfig(), batch, attn_impl="torch")
    loss_r, grads_r = float(m["loss"]), {g: [x.grad for x in xs] for g, xs in _grad_groups(ref).items()}
    log(tag, vit_blocks=vit_depth, decoder_layers=text_layers,
        taps=list(getattr(small_cfg.vision, "deepstack_visual_indexes", ())),
        loss_kernel=loss_k, loss_plain=loss_p, loss_f32=loss_r)
    for group in grads_r:
        rel_k, cos_k = _agreement_sums(grads_k[group], grads_r[group])
        rel_p, cos_p = _agreement_sums(grads_p[group], grads_r[group])
        log(tag, group=group, kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
            plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, max_ratio=SLICE_REL_RATIO)
        if not rel_k <= SLICE_REL_RATIO * rel_p:
            raise RuntimeError(f"{group} gradients: the kernel path is further from float32 than "
                               f"the plain bf16 path ({rel_k} vs {rel_p})")
    del ref, grads_k, grads_p, grads_r
    torch.cuda.empty_cache()


# ---- GSPO ---------------------------------------------------------------------


def gspo_sample(proc, seed: int, frame_hw=(FRAME_H, FRAME_W)) -> dict:
    """GSPO_EXAMPLE through rl_sample_from_frames: 16 synthetic frames of
    ``frame_hw`` (252x336) at 2 fps and one synthetic keyframe, interleaved
    by its time."""
    rng = np.random.default_rng(seed + 2)
    frames = rng.integers(0, 256, size=(N_FRAMES, 3, *frame_hw), dtype=np.uint8)
    keyframe = rng.integers(0, 256, size=(3, *frame_hw), dtype=np.uint8)
    return rl_sample_from_frames(GSPO_EXAMPLE, proc, list(frames), FPS, [keyframe])


class CannedTraces:
    """The trainer's detokenize: row r of a group reads as GSPO_TRACES[r];
    the ByteTokenizer text of each call is kept in ``real``."""

    def __init__(self, proc):
        self.proc, self.calls, self.real = proc, 0, []

    def __call__(self, ids):
        self.real.append(self.proc.decode(ids))
        text = GSPO_TRACES[self.calls % len(GSPO_TRACES)]
        self.calls += 1
        return text


def _taps_kept(vision, vit_depth) -> int:
    """The deepstack taps (Qwen3-VL) of the first vit_depth blocks."""
    return sum(i < vit_depth for i in getattr(vision, "deepstack_visual_indexes", ()))


def _sub(tree, vit_depth, text_layers, vision=None):
    """The params of the first vit_depth ViT blocks (and the deepstack
    mergers of their taps, given the config's ``vision``) and text_layers
    decoder layers, Aria's projector kept; the tensors shared."""
    visual = {**tree["visual"], "blocks": tree["visual"]["blocks"][:vit_depth]}
    if "deepstack" in visual:
        visual["deepstack"] = visual["deepstack"][:_taps_kept(vision, vit_depth)]
    return {**tree, "visual": visual,
            "text": {**tree["text"], "layers": tree["text"]["layers"][:text_layers]}}


def _cut_cfg(cfg, vit_depth, text_layers):
    text = dataclasses.replace(cfg.text, num_hidden_layers=text_layers)
    if is_aria(cfg):
        return dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=vit_depth), text=text)
    taps = cfg.vision.deepstack_visual_indexes[:_taps_kept(cfg.vision, vit_depth)]
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=vit_depth,
                                        deepstack_visual_indexes=taps), text=text)


def gspo_step(trainer, sample, step: int, tag: str, required) -> dict:
    """One GSPOTrainer.step with the launch counts set to 0 just before it:
    stage seconds, completion lengths, loss, kl, rewards, peak GiB and each
    kernel's launches (those of ``required`` must be > 0)."""
    trainer.timer.reset()
    norms, update = [], trainer.optimizer.update

    def record(state, norm):  # the gradient norm the update clips by
        norms.append(norm)
        update(state, norm)

    trainer.optimizer.update = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        m, decode = decode_run(trainer.engine, lambda: trainer.step(sample, global_step=step,
                                                                    max_steps=GSPO_MAX_STEPS))
    finally:
        del trainer.optimizer.update
    seconds = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in TPU_KERNELS}
    last = trainer.last_step
    stages = {k: v["total_s"] for k, v in trainer.timer.report().items()}
    log("gspo", run=tag, step=step + 1, seconds=round(seconds, 3), stage_seconds=stages,
        prompt_tokens=len(sample["input_ids"]), padded_prompt=last["batch"]["prompt_length"],
        completion_lengths=[len(ids) for ids in last["completion_ids"]],
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        use_vision=last["use_vision"], degraded=last["n_degraded"],
        rollout_decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
        decode_steps=decode["steps"], wasted_steps=decode["wasted"],
        rollout_prefill_s=decode["prefill_s"], rollout_vision_s=decode["vision_s"],
        rollout_prefix_blocks=decode["scheduler"]["prefix_blocks"],
        rollout_admissions=decode["scheduler"]["admissions"])
    log("gspo", run=tag, step=step + 1, loss=m["loss"], kl=m["kl"], reward=m["reward"],
        grad_norm=float(norms[0]), advantages=last["advantages"].tolist(),
        rewards={k.split("/")[1]: v for k, v in m.items() if k.startswith("rewards/")})
    log("gspo", run=tag, step=step + 1, launches=launches)
    if not (np.isfinite(m["loss"]) and np.isfinite(m["kl"])):
        raise RuntimeError(f"GSPO {tag}: non-finite loss or kl: {m}")
    if last["n_degraded"] or not last["use_vision"]:
        raise RuntimeError(f"GSPO {tag}: the sample degraded or the reference logps fell back "
                           "to text-only")
    if not np.any(last["advantages"]):
        raise RuntimeError(f"GSPO {tag}: every advantage is 0")
    missing = [name for name in required if not launches[name]]
    if missing:
        raise RuntimeError(f"GSPO {tag}: a kernel of the path never launched: {missing}")
    return {"metrics": m, "tokens": [list(t) for t in last["completion_ids"]],
            "rewards": last["rewards_per_func"].copy(), "launches": launches,
            "norm": float(norms[0]), "seconds": round(seconds, 3),
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}


def gspo_phase(params, cfg, proc, seed: int) -> tuple[GSPOTrainer, dict, dict]:
    """GSPO under PEFT on the full 7B (frozen; adapters from --seed): step 1,
    a checkpoint, step 2; then the step-1 checkpoint restored and step 2
    again, which must give the same tokens, rewards, loss and kl. The
    adapters' B must move off 0 and every base weight stay bit for bit.
    Returns the trainer, the sample and step 1's launch counts."""
    for x in P.leaves(params):
        x.requires_grad_(False)
    base = [x.to("cpu", copy=True) for x in P.leaves(params)]  # on the host: no device peak
    sample = gspo_sample(proc, seed)
    detok = CannedTraces(proc)
    lora = LoraConfig(seed=seed)
    trainer = GSPOTrainer(params, None, cfg, GSPOConfig(), detokenize=detok, lora=lora,
                          seed=seed)
    log("gspo", mode="PEFT", lora_rank=lora.rank, lora_alpha=lora.alpha,
        targets=list(lora.target_modules), adapter_params=sum(x.numel() for x in
                                                              adapter_leaves(trainer.adapters)),
        base_params=P.count(params), config=dataclasses.asdict(trainer.cfg),
        images=len(sample["grid_thw"]), patches=sample["pixel_patches"].shape[0])
    first = gspo_step(trainer, sample, 0, "peft", GSPO_KERNELS)
    real = detok.real[-len(first["tokens"]):]
    per_func, total = sum_rewards(
        [[{"role": "assistant", "content": t}] for t in real], list(REWARD_REGISTRY.values()),
        **{k: [v] * len(real) for k, v in {**sample["reward_kwargs"], "step_percent": 0.5}.items()})
    log("gspo", real_text_bytes=[len(t) for t in real], real_text_head=[ascii(t[:24]) for t in real],
        real_text_rewards=total.tolist())
    ckpt_dir = GSPO_CKPT_DIR
    state = {"params": trainer.adapters, "opt_state": trainer.opt_state,
             "meta": {"step": 1, "seed": trainer.seed}}
    t0 = time.perf_counter()
    path = CKPT.save_checkpoint(ckpt_dir, 1, state)
    log("gspo", checkpoint=path, save_seconds=round(time.perf_counter() - t0, 3))
    second = gspo_step(trainer, sample, 1, "peft", GSPO_KERNELS)
    restored, step = CKPT.restore_checkpoint(ckpt_dir, 1, target=state)
    trainer.opt_state = restored["opt_state"]
    again = gspo_step(trainer, sample, 1, "peft, step 2 after restoring step 1", GSPO_KERNELS)
    same = {"tokens": again["tokens"] == second["tokens"],
            "rewards": bool(np.array_equal(again["rewards"], second["rewards"])),
            "loss": again["metrics"]["loss"] == second["metrics"]["loss"],
            "kl": again["metrics"]["kl"] == second["metrics"]["kl"]}
    shutil.rmtree(ckpt_dir)
    log("gspo", restored_step=step, identical_step2=same)
    if not all(same.values()):
        raise RuntimeError(f"step 2 after restoring step 1's checkpoint differs: {same}")
    b_max = max(ab["b"].abs().max().item() for layer in trainer.adapters["layers"]
                for ab in layer.values())
    unchanged = all(torch.equal(x.cpu(), y) for x, y in zip(P.leaves(params), base))
    log("gspo", adapters_b_max_abs=b_max, base_bit_for_bit_unchanged=unchanged,
        safetensors_package=_has_safetensors())
    del base
    if not b_max > 0:
        raise RuntimeError("the adapters' B did not move off 0")
    if not unchanged:
        raise RuntimeError("a base weight changed under PEFT")
    return trainer, sample, first["launches"]


def gspo_rollout_pair(trainer, sample) -> None:
    """One rollout as the GSPO step makes it (the trainer's policy, the base
    with its current adapters grafted on; its sampling and seed; G copies of
    the sample), at GSPO_CHECK_TOKENS tokens a row, graphed and eager: the
    tokens must be equal."""
    cfg = trainer.cfg
    req = Request(input_ids=list(sample["input_ids"]), pixel_patches=sample["pixel_patches"],
                  grid_thw=sample["grid_thw"], vision_token_id=sample.get("vision_token_id"))
    reqs = [req] * cfg.num_generations
    sampling = SamplingParams(temperature=cfg.temperature, top_p=cfg.top_p, repetition_penalty=1.0,
                              max_tokens=GSPO_CHECK_TOKENS, seed=trainer.seed)
    policy = trainer.policy_params()
    engine = InferenceEngine(policy, trainer.model_cfg)
    outs, graph = decode_run(engine, lambda: engine.generate(reqs, sampling))
    eager_pair("GSPO rollout", policy, trainer.model_cfg, reqs, sampling, outs, graph)
    del engine, policy
    torch.cuda.empty_cache()


def _has_safetensors() -> bool:
    try:
        import safetensors  # noqa: F401
    except ImportError:
        return False
    return True


def gspo_full_phase(params, cfg, proc, sample, seed: int, vit_depth=FT_VIT_DEPTH,
                    text_layers=FT_TEXT_LAYERS, required=FT_KERNELS,
                    tag="full fine-tune") -> dict:
    """The full fine-tune branch at full width and vit_depth ViT blocks /
    text_layers decoder layers: a trained copy of those weights against
    the frozen originals as ``ref_params``, one GSPOTrainer step. Every
    training kernel of the path (``required``), K6 among them, must
    launch."""
    small_cfg = _cut_cfg(cfg, vit_depth, text_layers)
    ref = _sub(params, vit_depth, text_layers, cfg.vision)
    trained = _clone(ref)
    trainer = GSPOTrainer(trained, ref, small_cfg, GSPOConfig(), detokenize=CannedTraces(proc),
                          seed=seed)
    log("gspo", mode=tag, vit_blocks=vit_depth, decoder_layers=text_layers,
        trained_params=sum(x.numel() for x in trainer.trained_leaves()))
    out = gspo_step(trainer, sample, 0, tag, required)
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(P.leaves(trained), P.leaves(ref)))
    log("gspo", run=tag, leaves_moved=moved, leaves=len(P.leaves(trained)))
    if not moved:
        raise RuntimeError("the full fine-tune step moved no weight")
    del trainer, trained
    gc.collect()
    torch.cuda.empty_cache()
    return out["launches"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _gspo_loss_and_grads(params, adapters, scale, cfg, batch, impl, dtype):
    """The GSPO loss, policy logps and adapter gradients of one path: the
    reference logps recomputed by the same path without grad."""
    b = {k: batch[k] for k in ("pixel_patches", "grid_thw", "vision_token_id", "vision_row_index")}
    common = (batch["input_ids"], batch["position_ids"], batch["attn_valid"])
    Lp = batch["prompt_length"]
    with torch.no_grad():
        ref = completion_logps(params, cfg, *common, Lp, **b, logp_chunk=256, attn_impl=impl)
    ad = {"layers": [{n: {k: x.detach().to(dtype).requires_grad_(True) for k, x in ab.items()}
                      for n, ab in layer.items()} for layer in adapters["layers"]]}
    loss, aux = gspo_loss(apply_adapters(params, ad, scale), cfg, GSPOConfig(),
                          *common, batch["completion_mask"], Lp, ref, batch["advantages"], **b,
                          remat=True, logp_chunk=256, attn_impl=impl)
    loss.backward()
    leaves = adapter_leaves(ad)
    grads = {"a": [x.grad for x in leaves[0::2]], "b": [x.grad for x in leaves[1::2]]}
    return float(loss.detach()), aux["policy_logps"].detach().float(), grads


def gspo_numerics_phase(params, cfg, trainer) -> None:
    """GSPO numerics at full width, NUMERICS_VIT_DEPTH ViT blocks and
    NUMERICS_TEXT_LAYERS decoder layers, on the last step's packed batch and
    the trained adapters of those layers: the policy logps and the adapter
    gradients (A and B) of the kernel path and of the plain bf16 path, each
    against float32. The kernel path may be at most SLICE_REL_RATIO further
    from float32 than the plain path."""
    small_cfg = _cut_cfg(cfg, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS)
    small = _sub(params, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS)
    adapters = {"layers": trainer.adapters["layers"][:NUMERICS_TEXT_LAYERS]}
    batch = trainer.last_step["batch"]
    scale = trainer.lora.scale
    loss_k, logps_k, grads_k = _gspo_loss_and_grads(small, adapters, scale, small_cfg, batch,
                                                    "auto", torch.bfloat16)
    loss_p, logps_p, grads_p = _gspo_loss_and_grads(small, adapters, scale, small_cfg, batch,
                                                    "torch", torch.bfloat16)
    cfg32 = dataclasses.replace(small_cfg, dtype=torch.float32)
    small32 = _cast(small, torch.float32)
    loss_r, logps_r, grads_r = _gspo_loss_and_grads(small32, adapters, scale, cfg32, batch,
                                                    "torch", torch.float32)
    log("gspo_numerics", vit_blocks=NUMERICS_VIT_DEPTH, decoder_layers=NUMERICS_TEXT_LAYERS,
        loss_kernel=loss_k, loss_plain=loss_p, loss_f32=loss_r)
    rel_k, cos_k = _agreement(logps_k, logps_r)
    rel_p, cos_p = _agreement(logps_p, logps_r)
    checks = [("policy logps", rel_k, rel_p)]
    log("gspo_numerics", what="policy logps", kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
        plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, max_ratio=SLICE_REL_RATIO)
    for group in grads_r:
        rel_k, cos_k = _agreement_sums(grads_k[group], grads_r[group])
        rel_p, cos_p = _agreement_sums(grads_p[group], grads_r[group])
        checks.append((f"adapter {group} gradients", rel_k, rel_p))
        log("gspo_numerics", what=f"adapter {group} gradients", kernel_vs_f32_rel=rel_k,
            kernel_vs_f32_cos=cos_k, plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p,
            max_ratio=SLICE_REL_RATIO)
    del small32, grads_k, grads_p, grads_r
    torch.cuda.empty_cache()
    for what, rel_k, rel_p in checks:
        if not (np.isfinite(rel_k) and rel_k <= SLICE_REL_RATIO * rel_p):
            raise RuntimeError(f"GSPO {what}: the kernel path is further from float32 than the "
                               f"plain bf16 path ({rel_k} vs {rel_p})")


# ---- the SFT app -------------------------------------------------------------


def media_phase() -> dict:
    """15a: what the machine offers for reading media, decided before
    anything is read: g++ and the libav headers and libraries (with their
    paths), cv2, and the readers the port will use for videos and images."""
    found = video_decoder.probe_libav()
    missing = video_decoder.missing()
    has_cv2 = TV._has_cv2()
    native = not missing
    media = {
        "native": native, "cv2": has_cv2,
        "video_reader": TV.FORCE_VIDEO_READER or ("native" if native else
                                                  "cv2" if has_cv2 else None),
        "image_reader": "cv2" if has_cv2 else "native" if native else None,
    }
    log("media", gpp=found["g++"], headers=found["headers"], libraries=found["libraries"])
    log("media", libav="present" if native else f"absent (missing {missing})", cv2=has_cv2,
        video_reader=media["video_reader"], image_reader=media["image_reader"],
        decoder="builds at first use" if native else "not built: nothing can be installed")
    return media


def sft_app_data(seed: int, media: dict) -> str:
    """15b: the AVI and the PNG keyframe in the reference's layout under
    SFT_APP_DIR, the dataset json beside them; each lossless file read back
    by every reader present must give the written pixels, and fetch_video
    must give SFT_APP_NFRAMES frames at smart_resize's size. Returns the
    data root."""
    rng = np.random.default_rng(seed + 5)
    frames = rng.integers(0, 256, size=(SFT_APP_FRAMES, FRAME_H, FRAME_W, 3), dtype=np.uint8)
    keyframe = rng.integers(0, 256, size=(FRAME_H, FRAME_W, 3), dtype=np.uint8)
    data = f"{SFT_APP_DIR}/data"
    avis = [f"{data}/videos/stgr/plm/videos/clip.avi", f"{data}/videos/videor1/clip.avi"]
    png = f"{data}/videos/stgr/plm/kfs/kf0.png"
    for path in avis + [png]:
        os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    for path in avis:
        write_raw_avi(path, frames, SFT_APP_FPS)
    write_png(png, keyframe)
    log("media", wrote=avis + [png], avi_mb=round(os.path.getsize(avis[0]) / 2**20, 3),
        write_s=round(time.perf_counter() - t0, 3))
    with open(f"{SFT_APP_DIR}/sft.json", "w") as f:
        json.dump(SFT_APP_EXAMPLES, f)
    exact = {}
    if media["native"]:
        t0 = time.perf_counter()
        lib = video_decoder.build()
        log("media", decoder_build_s=round(time.perf_counter() - t0, 3), library=str(lib))
        meta = video_decoder.probe(avis[0])
        t0 = time.perf_counter()
        got = video_decoder.decode_frames(avis[0], np.arange(SFT_APP_FRAMES))
        decode_s = time.perf_counter() - t0
        exact["native avi"] = bool(np.array_equal(got, frames))
        exact["native png"] = bool(np.array_equal(TV._read_image_native(png), keyframe))
        log("media", probe=vars(meta), decode_32_frames_ms=round(1e3 * decode_s, 3))
    if media["cv2"]:
        import cv2

        cap = cv2.VideoCapture(avis[0])
        got = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            got.append(frame[:, :, ::-1])
        cap.release()
        exact["cv2 avi"] = len(got) == SFT_APP_FRAMES and bool(np.array_equal(np.stack(got), frames))
        exact["cv2 png"] = bool(np.array_equal(TV.read_image(png), keyframe))
    t0 = time.perf_counter()
    video, fps = TV.fetch_video({"video": avis[0], "nframes": SFT_APP_NFRAMES})
    fetch_s = time.perf_counter() - t0
    h, w = TV.smart_resize(FRAME_H, FRAME_W, min_pixels=TV.VIDEO_MIN_PIXELS, max_pixels=max(
        min(TV.VIDEO_MAX_PIXELS, TV.VIDEO_TOTAL_PIXELS / SFT_APP_NFRAMES * TV.FRAME_FACTOR),
        int(TV.VIDEO_MIN_PIXELS * 1.05)))
    log("media", exact=exact, reader=TV.get_video_reader_backend(),
        fetch_video_shape=list(video.shape), sample_fps=fps, fetch_video_ms=round(1e3 * fetch_s, 3))
    if not all(exact.values()):
        raise RuntimeError(f"a lossless file did not read back exactly: {exact}")
    if video.shape != (SFT_APP_NFRAMES, 3, h, w) or not np.isfinite(video).all():
        raise RuntimeError(f"fetch_video gave {video.shape}, expected {(SFT_APP_NFRAMES, 3, h, w)}")
    return data


def fingerprint(params) -> torch.Tensor:
    """Per leaf, the sum and the sum of squares of its bits read as int16,
    in int64 (chunks of 2^26 values): a base too large to copy beside
    itself is checked unchanged by this, where any in-place update (a
    decay, a step) moves both sums."""
    out = []
    for x in P.leaves(params):
        bits = x.detach().reshape(-1).view(torch.int16)
        acc = torch.zeros(2, dtype=torch.int64, device=x.device)
        for i in range(0, bits.numel(), 1 << 26):
            b = bits[i:i + (1 << 26)].long()
            acc += torch.stack([b.sum(), (b * b).sum()])
        out.append(acc)
    return torch.stack(out)


def batch_vision(batch) -> dict:
    """A batch's tokens (its valid ones) and vision, for the log: images
    and patches (the Qwen families), or images of Aria's square crops."""
    tokens = int(batch["attn_valid"].sum()) if "attn_valid" in batch else batch["input_ids"].size
    if "pixel_values" in batch:
        return {"tokens": tokens, "images": int(batch["pixel_values"].shape[0]),
                "image_hw": list(batch["pixel_values"].shape[2:])}
    return {"tokens": tokens, "images": len(batch["grid_thw"]),
            "patches": batch["pixel_patches"].shape[0]}


def sft_peft_phase(params, cfg, batch, seed: int, source: str, steps=SFT_APP_STEPS,
                   required=SFT_PEFT_KERNELS, absent=SFT_PEFT_ABSENT, tag="sft_app",
                   copy_base=True) -> dict:
    """15c: `steps` PEFT steps of make_lora_train_step on the frozen 7B
    (sft_main's default adapters from --seed; SFTConfig defaults; the last
    step under the profiler: device time by kernel class, busy share), the
    launch counts set to 0 just before and read just after: the kernels of
    ``required`` launched (K1 and K2 in their inference modes, K3 exact and
    K5), those of ``absent`` not (K6). The adapters' B must move off 0 and
    the base stay bit for bit (``copy_base=False``: its fingerprint, for a
    base that a copy does not fit beside). Returns the launches."""
    for x in P.leaves(params):
        x.requires_grad_(False)
    # A copy of the base on the card (~10 ms, where a host copy and its
    # check take ~16 s); its bytes are resident through the steps, and
    # allocated bytes add, so the steps' peak is the peak less the copy.
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    base = [x.clone() for x in P.leaves(params)] if copy_base else fingerprint(params)
    torch.cuda.synchronize()
    copy_bytes = torch.cuda.memory_allocated() - held
    copy_s = time.perf_counter() - t0
    lora = LoraConfig(seed=seed)
    train_cfg = SFTConfig()
    adapters = init_adapters(params, lora, dtype=torch.bfloat16)
    opt = make_optimizer(train_cfg)
    state = opt.init(adapter_leaves(adapters))
    step = make_lora_train_step(cfg, train_cfg, opt, lora.scale)
    log(tag, mode="PEFT", input=source, lora_rank=lora.rank, lora_alpha=lora.alpha,
        targets=list(lora.target_modules),
        adapter_params=sum(x.numel() for x in adapter_leaves(adapters)), **batch_vision(batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for i in range(steps):
        last = i == steps - 1  # the last step runs under the profiler
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=activities) if last else contextlib.nullcontext()
        t0 = time.perf_counter()
        with prof:
            _, state, m = step(adapters, state, batch, params)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if last:
            log(tag, profiled=f"step {i + 1}", **device_breakdown(prof, wall))
        log(tag, step=i + 1, seconds=round(wall, 3),
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            num_target_tokens=int(m["num_target_tokens"]),
            peak_mem_gib=round((torch.cuda.max_memory_allocated() - copy_bytes) / 2**30, 3))
        if not (np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))):
            raise RuntimeError(f"PEFT SFT step {i + 1}: non-finite loss or gradient norm")
    launches = {name: kernels.LAUNCHES[name] for name in TPU_KERNELS}
    log(tag, launches_per_step={k: n / steps for k, n in launches.items() if n})
    missing = [name for name in required if not launches[name]]
    extra = [name for name in absent if launches[name]]
    if missing or extra:
        raise RuntimeError(f"PEFT SFT launches: never launched {missing}, launched {extra}")
    b_max = max(ab["b"].abs().max().item() for layer in adapters["layers"]
                for ab in layer.values())
    t0 = time.perf_counter()
    unchanged = (all(torch.equal(x, y) for x, y in zip(P.leaves(params), base)) if copy_base
                 else torch.equal(fingerprint(params), base))
    log(tag, adapters_b_max_abs=b_max, base_bit_for_bit_unchanged=unchanged,
        base_copy_gib=round(copy_bytes / 2**30, 3), base_copy_s=round(copy_s, 3),
        base_check_s=round(time.perf_counter() - t0, 3))
    del base, adapters, state
    gc.collect()
    torch.cuda.empty_cache()
    if not b_max > 0:
        raise RuntimeError("the adapters' B did not move off 0")
    if not unchanged:
        raise RuntimeError("a base weight changed under PEFT")
    return launches


def _sft_main_run(tag: str, args: list[str]) -> dict:
    """One sft_main.main call: its seconds, peak GiB, the metrics lines it
    printed (by step) and the seconds between them."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sft_main.main(args)
    seconds = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith('{"step"')]
    steps = {x["step"]: x for x in lines}
    times = [x["time"] for x in lines]
    log("sft_main", run=tag, seconds=round(seconds, 3),
        step_seconds=[round(b - a, 3) for a, b in zip(times, times[1:])],
        losses={k: v["loss"] for k, v in steps.items()},
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    return steps


def sft_main_phase(params, cfg, data: str) -> None:
    """15d: sft_main.main end to end on phase 10's cut of the model (full
    width, NUMERICS_VIT_DEPTH ViT blocks, NUMERICS_TEXT_LAYERS decoder
    layers) written as a checkpoint directory (no tokenizer files), --use_peft
    with its default adapters: run A 2 steps with a checkpoint each step, run
    B 1 step, run C resuming B to 2 steps. C's step 2 loss and its merged
    export must equal A's bit for bit."""
    small_cfg = _cut_cfg(cfg, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS)
    model = f"{SFT_APP_DIR}/model"
    t0 = time.perf_counter()
    CKPT.export_safetensors(_sub(params, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS), small_cfg,
                            model)
    log("sft_main", model=model, vit_blocks=NUMERICS_VIT_DEPTH,
        decoder_layers=NUMERICS_TEXT_LAYERS,
        gib=round(os.path.getsize(f"{model}/model.safetensors") / 2**30, 3),
        write_s=round(time.perf_counter() - t0, 3))
    common = ["--model_name_or_path", model, "--dataset_name", f"{SFT_APP_DIR}/sft.json",
              "--data_root", data, "--nframes", str(SFT_APP_NFRAMES), "--use_peft"]
    a = _sft_main_run("A: 2 steps, a checkpoint each", common + [
        "--output_dir", f"{SFT_APP_DIR}/a", "--max_steps", "2", "--save_steps", "1"])
    _sft_main_run("B: 1 step", common + ["--output_dir", f"{SFT_APP_DIR}/b", "--max_steps", "1"])
    c = _sft_main_run("C: B resumed to 2 steps", common + [
        "--output_dir", f"{SFT_APP_DIR}/b", "--max_steps", "2",
        "--resume_from_checkpoint", f"{SFT_APP_DIR}/b"])
    same = {"step 2 loss": a[2]["loss"] == c[2]["loss"],
            "step 2 grad norm": a[2]["grad_norm"] == c[2]["grad_norm"],
            "merged export": filecmp.cmp(f"{SFT_APP_DIR}/a/model.safetensors",
                                         f"{SFT_APP_DIR}/b/model.safetensors", shallow=False)}
    log("sft_main", resumed_equals_straight=same)
    if not all(same.values()):
        raise RuntimeError(f"sft_main resumed from step 1 differs from 2 steps straight: {same}")


def sft_app_phase(params, cfg, proc, seed: int) -> dict:
    """Phase 15: [media], then (with a reader) the files and their reads,
    the PEFT SFT step on the 7B over collate_sft_batch of the
    temporal-spatial example (else over phase 9's synthetic frames), then
    sft_main end to end (with a reader). Returns the PEFT step's launches."""
    media = media_phase()
    shutil.rmtree(SFT_APP_DIR, ignore_errors=True)
    try:
        if media["video_reader"]:
            data = sft_app_data(seed, media)
            t0 = time.perf_counter()
            example = prepare_sft_example(SFT_APP_EXAMPLES[0], data)
            batch = collate_sft_batch([example], proc, cfg, data, nframes=SFT_APP_NFRAMES)
            source = f"collate_sft_batch: the AVI and the PNG keyframe ({media['video_reader']})"
            log("sft_app", collate_s=round(time.perf_counter() - t0, 3))
        else:
            log("media", skipped="15b and 15d: no reader for video files on this machine")
            batch, source = sft_batch(proc, cfg, seed), "collate_sft_frames: synthetic frames"
        launches = sft_peft_phase(params, cfg, batch, seed, source)
        if media["video_reader"]:
            sft_main_phase(params, cfg, data)
    finally:
        shutil.rmtree(SFT_APP_DIR, ignore_errors=True)
    return launches


# ---- eval ----------------------------------------------------------------------


def _vstar_item(idx: int, path: str) -> dict:
    """An item in V-STAR's annotation layout over the eval AVI."""
    return {"vid": f"item{idx}", "video_path": path, "domain": "sports",
            "question": "What is the color of the bowling ball?",
            "temporal_question": "When does the bowling ball reach the pins?",
            "spatial_question": "Where is the bowling ball?",
            "spatial_question_2": "Where is the bowling ball when it hits the pins?",
            "answer": "The bowling ball is red.", "timestamps": [4.0, 9.0],
            "frame_count": int(EVAL_SECONDS * EVAL_FPS), "fps": EVAL_FPS,
            "width": EVAL_W, "height": EVAL_H,
            "bboxes": [{"timestamp": 5, "xmin": 250, "ymin": 120, "xmax": 330, "ymax": 200},
                       {"timestamp": 8, "xmin": 420, "ymin": 90, "xmax": 480, "ymax": 150}]}


def eval_data(seed: int) -> dict:
    """16a.1: the two AVIs (written without an encoder), V-STAR's 3-item
    annotation file (two items over the AVI, one naming a missing video)
    and TVGBench's (three queries over the AVI, no duration: it is probed)."""
    rng = np.random.default_rng(seed + 16)
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    os.makedirs(f"{EVAL_DIR}/videos")
    avi, mcq_avi = f"{EVAL_DIR}/videos/bowling.avi", f"{EVAL_DIR}/videos/mcq.avi"
    t0 = time.perf_counter()
    n = int(EVAL_SECONDS * EVAL_FPS)
    write_raw_avi(avi, rng.integers(0, 256, size=(n, EVAL_H, EVAL_W, 3), dtype=np.uint8), EVAL_FPS)
    n_mcq = int(MCQ_SECONDS * MCQ_FPS)
    write_raw_avi(mcq_avi, rng.integers(0, 256, size=(n_mcq, EVAL_H, EVAL_W, 3), dtype=np.uint8),
                  MCQ_FPS)
    anno = [_vstar_item(0, avi), _vstar_item(1, f"{EVAL_DIR}/videos/missing.avi"),
            _vstar_item(2, avi)]
    with open(f"{EVAL_DIR}/vstar.json", "w") as f:
        json.dump(anno, f)
    with open(f"{EVAL_DIR}/tvgbench.json", "w") as f:
        json.dump([{"video": "bowling.avi", "query": q, "timestamps": [4.0, 9.0]}
                   for q in TVG_QUERIES], f)
    log("eval", wrote=[avi, mcq_avi], frames=[n, n_mcq], size=f"{EVAL_W}x{EVAL_H}",
        mb=[round(os.path.getsize(x) / 2**20, 3) for x in (avi, mcq_avi)],
        write_s=round(time.perf_counter() - t0, 3))
    return {"avi": avi, "mcq_avi": mcq_avi, "anno": anno}


def eval_config(name: str) -> dict:
    """configs/eval/<name> as the CLI reads it, max_tokens cut to
    EVAL_MAX_TOKENS (printed)."""
    from open_o3_video_tpu_torch.eval import cli

    kwargs = cli.read_flat_yaml(f"configs/eval/{name}")
    log("eval", config=name, max_tokens=f"{kwargs['max_tokens']} cut to {EVAL_MAX_TOKENS}",
        **{k: v for k, v in kwargs.items() if k != "max_tokens"})
    return {**kwargs, "max_tokens": EVAL_MAX_TOKENS}


def _calls_line(model, since: int) -> dict:
    """The records of ``model``'s engine calls from ``since`` on, for a log
    line: requests, tower passes, admissions, prefix blocks, seconds and
    stage seconds of each call."""
    calls = model.calls[since:]
    return {"calls": len(calls), "requests_per_call": [c["requests"] for c in calls],
            "tower_passes_per_call": [c["tower_passes"] for c in calls],
            "admissions_per_call": [c["admissions"] for c in calls],
            "prefix_blocks_per_call": [c["prefix_blocks"] for c in calls],
            "seconds_per_call": [round(c["seconds"], 3) for c in calls],
            "stage_seconds_per_call": [{k: round(v, 3) for k, v in c["stage_seconds"].items()}
                                       for c in calls]}


@contextlib.contextmanager
def recording(engine, waves: list | None = None):
    """The token ids of every ``engine.generate`` call (a wave) made while
    the block runs, one list of rows per call. Where ``waves`` is a list,
    each call also appends its EVAL_KERNELS launches (the counts set to 0
    just before the call, read just after) and each request's grid_thw
    entries."""
    calls: list[list[list[int]]] = []
    generate = engine.generate

    def recorded(requests, *args, **kw):
        if waves is not None:
            torch.cuda.synchronize()
            kernels.reset_launches()
        outs = generate(requests, *args, **kw)
        calls.append([o["token_ids"] for o in outs])
        if waves is not None:
            torch.cuda.synchronize()
            waves.append({"launches": {n: kernels.LAUNCHES[n] for n in EVAL_KERNELS},
                          "grid_entries": [0 if r.grid_thw is None else len(r.grid_thw)
                                           for r in requests]})
        return outs

    engine.generate = recorded
    try:
        yield calls
    finally:
        del engine.generate


def check_rows(path: str, calls, budget: int, eos: int) -> int:
    """Every row of ``calls`` holds tokens and ran to ``budget`` or to an
    EOS, so that a graphed/eager comparison of them compares real tokens.
    Returns the number of rows."""
    rows = [row for call in calls for row in call]
    short = [len(r) for r in rows if not r or (len(r) != budget and r[-1] != eos)]
    if not rows or short:
        raise RuntimeError(f"{path}: {len(rows)} rows, of which {len(short)} neither ran to "
                           f"the budget of {budget} nor ended in EOS: lengths {short}")
    return len(rows)


def vstar_phase(params, cfg, data) -> tuple[object, str, list]:
    """16a.2-3: vstar.evaluate with item_batch EVAL_ITEM_BATCH (the launch
    counts set to 0 just before, read just after: K1, K2 and K3 > 0), the
    missing video recorded in *_errors.json; evaluate again decoding
    eagerly, and item 0's wave again graphed: each wave's token ids equal
    those of the graphed evaluate, every row EVAL_MAX_TOKENS long. Returns
    the model, the results file and the V-STAR launch counts."""
    from open_o3_video_tpu_torch.eval import QwenVLEngine, vstar

    model = QwenVLEngine(params, rt_shape=True, cfg=cfg, processor=O3VideoProcessor(),
                         **eval_config("vstar.yaml"))
    engine = model.engine
    out = f"{EVAL_DIR}/vstar_results.json"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(engine) as graph_tokens:
        results, graph = decode_run(engine, lambda: vstar.evaluate(
            f"{EVAL_DIR}/vstar.json", f"{EVAL_DIR}/videos", model, out, item_batch=EVAL_ITEM_BATCH))
    seconds = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in EVAL_KERNELS}
    with open(f"{EVAL_DIR}/vstar_results_errors.json") as f:
        errors = json.load(f)
    log("eval", bench="vstar", items=len(data["anno"]), item_batch=EVAL_ITEM_BATCH,
        results=len(results), errors=errors, seconds=round(seconds, 3), **_calls_line(model, 0),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), launches=launches)
    inputs, size = vstar.prepare_item_inputs(data["anno"][0], data["avi"], model)
    log("eval", bench="vstar", frame_size=size, prompt_tokens={
        k: len(model._request_from_raw(x).input_ids) for k, x in inputs.items()})
    log("eval", bench="vstar", answer_vqa_chars=[len(r["answer_vqa"]) for r in results],
        answer_temporal=[r["answer_temporal"] for r in results],
        answer_spatial=[r["answer_spatial"] for r in results])
    if [r["vid"] for r in results] != ["item0", "item2"] or [e["vid"] for e in errors] != ["item1"]:
        raise RuntimeError(f"V-STAR: expected items 0 and 2 scored and item 1 recorded, got "
                           f"{[r['vid'] for r in results]} and {errors}")
    if not all(launches.values()):
        raise RuntimeError(f"V-STAR: a kernel of the path never launched: {launches}")
    rows = check_rows("vstar evaluate", graph_tokens, EVAL_MAX_TOKENS, cfg.eos_token_id)

    engine.decode_graph = False  # evaluate again, decoding eagerly: the reference
    with recording(engine) as eager_tokens:
        again, eager = decode_run(engine, lambda: vstar.evaluate(
            f"{EVAL_DIR}/vstar.json", f"{EVAL_DIR}/videos", model,
            f"{EVAL_DIR}/vstar_results_eager.json", item_batch=EVAL_ITEM_BATCH))
    engine.decode_graph = True
    log("eval", bench="vstar", rows=rows, waves_compared=len(graph_tokens),
        eager_results_equal=again == results)
    decode_pair("vstar evaluate", graph, eager, graph_tokens, eager_tokens)
    if again != results:
        raise RuntimeError("V-STAR: the eager evaluate's results differ from the graphed one's")

    item = dict(data["anno"][0], original_index=0)
    with recording(engine) as wave_tokens:  # item 0's wave again, without the prefetch thread
        vstar.process_items_batched([item], f"{EVAL_DIR}/videos", model)
    same = wave_tokens == eager_tokens[:1] == graph_tokens[:1]
    log("eval", bench="vstar", item0_wave_again_equals_eager_and_evaluate=same)
    if not same:
        raise RuntimeError("V-STAR: item 0's wave run again graphed gave other tokens than in "
                           "the eager and the graphed evaluate")
    return model, out, launches


def tvgbench_phase(model) -> None:
    """16a.4: tvgbench.evaluate over the AVI (durations probed by the reader
    the port picked), one item a chunk, so that each chunk's host work and
    upload run on the prefetch thread while the engine captures and
    replays the previous one; then again decoding eagerly: each chunk's
    token ids equal, every row EVAL_MAX_TOKENS long."""
    from open_o3_video_tpu_torch.eval import tvgbench

    t0 = time.perf_counter()
    duration = tvgbench.probe_duration(f"{EVAL_DIR}/videos/bowling.avi")
    log("eval", bench="tvgbench", reader=TV.get_video_reader_backend(), duration_s=duration,
        probe_ms=round(1e3 * (time.perf_counter() - t0), 3))
    runs = {}
    for graphed in (True, False):
        model.engine.decode_graph = graphed
        since = len(model.calls)
        out = f"{EVAL_DIR}/tvgbench_{'graph' if graphed else 'eager'}.json"
        t0 = time.perf_counter()
        with recording(model.engine) as calls:
            scores, decode = decode_run(model.engine, lambda: tvgbench.evaluate(
                f"{EVAL_DIR}/tvgbench.json", f"{EVAL_DIR}/videos", model, out, item_batch=1))
        with open(out) as f:
            written = json.load(f)
        runs[graphed] = calls, decode, [r["prediction_raw"] for r in written["results"]]
        log("eval", bench="tvgbench", decode="graph" if graphed else "eager", chunks=len(calls),
            seconds=round(time.perf_counter() - t0, 3), scores=scores, **_calls_line(model, since))
        if written["errors"] or len(written["results"]) != len(TVG_QUERIES):
            raise RuntimeError(f"TVGBench: {len(written['results'])} results, errors "
                               f"{written['errors']}")
    model.engine.decode_graph = True
    (graph_tokens, graph, graph_raw), (eager_tokens, eager, eager_raw) = runs[True], runs[False]
    check_rows("tvgbench", graph_tokens, EVAL_MAX_TOKENS, model.cfg.eos_token_id)
    if len(graph_tokens) != len(TVG_QUERIES):
        raise RuntimeError(f"TVGBench: {len(graph_tokens)} engine calls, expected one a chunk")
    decode_pair("tvgbench", graph, eager, graph_tokens, eager_tokens)
    if graph_raw != eager_raw:
        raise RuntimeError("TVGBench: the graphed run's predictions differ from the eager run's")
    if duration != EVAL_SECONDS:
        raise RuntimeError(f"TVGBench: the probe read {duration} s, expected {EVAL_SECONDS}")


def mcq_phase(params, cfg, data) -> None:
    """16a.5: evaluate_mcq_items_batched on one VideoMME-style item
    (video_mme.yaml's pixels and 64 frames, N = 2, confidence_voting), then
    run_images_scorer_batch on the crops tts.extract_and_crop makes from
    TTS_TRACE over the item's frames: ratings in {-1, 0, 1, 2}."""
    from open_o3_video_tpu_torch.eval import QwenVLEngine, evaluate_mcq_items_batched, tts
    from open_o3_video_tpu_torch.grounding.tags import parse_evidence_patterns

    model = QwenVLEngine(params, rt_shape=True, cfg=cfg, processor=O3VideoProcessor(),
                         **eval_config("video_mme.yaml"))
    spec = {"video_path": data["mcq_avi"], "text_input": MCQ_QUESTION, "image": None,
            "doc": {"question": MCQ_QUESTION, "options": MCQ_OPTIONS}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepared = model.prepare_paths_batch([(spec["video_path"], spec["text_input"], None)])
    prep_s = time.perf_counter() - t0
    _, frames, fps, shape = prepared[0]
    t0 = time.perf_counter()
    out = evaluate_mcq_items_batched(model, [spec], N=2, vote="confidence_voting",
                                     prepared=prepared)[0]
    seconds = time.perf_counter() - t0
    log("eval", bench="mcq", frames=list(frames.shape), sample_fps=fps, frame_shape=shape,
        prompt_tokens=len(prepared[0][0].input_ids), prepare_s=round(prep_s, 3),
        seconds=round(seconds, 3), pred=out["pred"], choice_score=out["choice_score"],
        path_chars=[len(p) for p in out["paths"]], **_calls_line(model, 0))
    crops = tts.extract_and_crop(frames, fps, parse_evidence_patterns(TTS_TRACE))
    msgs = tts.build_image_scorer_msgs(crops, MCQ_QUESTION)
    t0 = time.perf_counter()
    ratings = model.run_images_scorer_batch([(msgs, crops), (msgs, crops)])
    log("eval", bench="tts", crops=[list(c.shape) for c in crops], ratings=ratings,
        weights=[tts.relevance_mapping(r) for r in ratings],
        seconds=round(time.perf_counter() - t0, 3))
    if len(out["paths"]) != 2 or frames.shape[0] != 64 or len(crops) != 3:
        raise RuntimeError(f"MCQ: {len(out['paths'])} paths, {frames.shape[0]} frames, "
                           f"{len(crops)} crops")
    if not all(r in (-1, 0, 1, 2) for r in ratings):
        raise RuntimeError(f"TTS ratings outside {{-1, 0, 1, 2}}: {ratings}")


def tables_probe() -> dict:
    """16c.1 [tables]: pandas and pyarrow, which the dataloaders read their
    tables with (route (a): no reader of the port's own); a missing one
    fails the phase."""
    found = {}
    for name in ("pandas", "pyarrow"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError as e:
            found[name] = f"absent ({e})"
    log("tables", **found, reader="pandas (read_parquet, read_csv sep='\\t')")
    if any(v.startswith("absent") for v in found.values()):
        raise RuntimeError(f"the dataloaders read their tables with pandas and pyarrow: {found}")
    return found


def _bench_video(path: str, rng) -> None:
    n = int(MCQ_SECONDS * MCQ_FPS)
    write_raw_avi(path, rng.integers(0, 256, size=(n, EVAL_H, EVAL_W, 3), dtype=np.uint8), MCQ_FPS)


def bench_data(seed: int) -> dict:
    """16c.2: the three datasets under BENCH_DIR in their benchmarks'
    layouts: VideoMME's parquet, videos under data/ and one ASR transcript;
    WorldSense's TSV (candidates and audio classes as python-list literals)
    with BENCH_WS_TRUNCATED's video cut short; VideoMMMU's three parquet
    splits, the Adaptation item's image struct holding a PNG written by
    data/raw_media.py. Returns the data directories."""
    import pandas as pd

    rng = np.random.default_rng(seed + 163)
    t0 = time.perf_counter()
    mme, ws, mmmu = (f"{BENCH_DIR}/{b}" for b in ("videomme", "worldsense", "videommmu"))
    for d in (f"{mme}/videomme", f"{mme}/data", f"{mme}/asr", f"{ws}/asr"):
        os.makedirs(d, exist_ok=True)
    pd.DataFrame([{"video_id": f"{i:03d}", "duration": dur, "domain": dom, "sub_category": sub,
                   "url": "", "videoID": vid, "question_id": f"{i:03d}-1", "task_type": task,
                   "question": q, "options": opts, "answer": ans}
                  for i, (vid, dur, dom, sub, task, q, opts, ans) in enumerate(BENCH_MME)]
                 ).to_parquet(f"{mme}/videomme/test-00000-of-00001.parquet")
    for vid, *_ in BENCH_MME:
        _bench_video(f"{mme}/data/{vid}.mp4", rng)
    for vid, text in BENCH_MME_ASR.items():
        with open(f"{mme}/asr/{vid}.mp4.txt", "w", encoding="utf-8") as f:
            f.write(text)
    pd.DataFrame([{"index": i, "video": vid, "question": q, "candidates": str(c), "answer": a,
                   "duration": dur, "domain": dom, "sub_category": sub, "task_domain": td,
                   "task_type": tt, "audio_class": str(ac)}
                  for i, (vid, q, c, a, dur, dom, sub, td, tt, ac) in enumerate(BENCH_WS)]
                 ).to_csv(f"{ws}/WorldSense.tsv", sep="\t", index=False)
    for vid, *_ in BENCH_WS:
        _bench_video(f"{ws}/{vid}.mp4", rng)
    with open(f"{ws}/{BENCH_WS_TRUNCATED}.mp4", "r+b") as f:
        f.truncate(4096)
    png = f"{BENCH_DIR}/query.png"
    write_png(png, rng.integers(0, 256, size=(BENCH_IMAGE_H, BENCH_IMAGE_W, 3), dtype=np.uint8))
    with open(png, "rb") as f:
        image = {"bytes": f.read(), "path": "query.png"}
    for category, (vid, sub_dir, q, opts, ans, qtype) in BENCH_MMMU.items():
        os.makedirs(f"{mmmu}/{category}", exist_ok=True)
        os.makedirs(f"{mmmu}/{sub_dir}", exist_ok=True)
        row = {"id": vid, "question": q, "options": opts, "answer": ans, "question_type": qtype}
        if category == "Adaptation":
            row["image"] = image
        pd.DataFrame([row]).to_parquet(f"{mmmu}/{category}/test-00000-of-00001.parquet")
        _bench_video(f"{mmmu}/{sub_dir}/{vid}.mp4", rng)
    log("bench", wrote=len(BENCH_MME) + len(BENCH_WS) + len(BENCH_MMMU), kind="AVI as .mp4",
        frames=int(MCQ_SECONDS * MCQ_FPS), size=f"{EVAL_W}x{EVAL_H}",
        truncated=f"{BENCH_WS_TRUNCATED}.mp4 (4096 bytes)", image=f"{BENCH_IMAGE_W}x{BENCH_IMAGE_H} PNG",
        write_s=round(time.perf_counter() - t0, 3))
    return {"videomme": mme, "worldsense": ws, "videommmu": mmmu}


def _check_waves(bench: str, model, waves: list, cfg) -> list[dict]:
    """Each engine call's launches (set to 0 just before it, read just
    after): K1 once per window block and K2 once per global block of each
    tower pass, K3 once per decoder layer of each of its prefill forwards
    (admissions and prefix blocks, from the call's record)."""
    vis, layers = cfg.vision, cfg.text.num_hidden_layers
    glob = len(vis.fullatt_block_indexes)
    per_wave = []
    for record, wave in zip(model.calls, waves, strict=True):
        p = record["tower_passes"]
        want = {"fused_window_attention": (vis.depth - glob) * p, "window_attention": glob * p,
                "flash_attention_gqa": layers * record["prefills"]}
        per_wave.append({"requests": record["requests"], "tower_passes": p,
                         "prefills": record["prefills"], "launches": wave["launches"]})
        if wave["launches"] != want:
            raise RuntimeError(f"{bench}: a call of {p} tower passes and {record['prefills']} "
                               f"prefills launched {wave['launches']}, expected {want}")
    return per_wave


def bench_run(bench: str, model, data_dir: str, out: str, **kw):
    """One harness's evaluate through ``model`` with each wave recorded
    (token ids, launches, grid entries); returns (the recorded calls and
    waves, the decode's numbers, seconds)."""
    from open_o3_video_tpu_torch.eval import videomme, videommmu, worldsense

    harness = {"videomme": videomme, "worldsense": worldsense, "videommmu": videommmu}[bench]
    waves: list = []
    t0 = time.perf_counter()
    with recording(model.engine, waves) as calls:
        _, decode = decode_run(model.engine, lambda: harness.evaluate(
            model, data_dir, out, item_batch=EVAL_ITEM_BATCH, **kw))
    return calls, waves, decode, time.perf_counter() - t0


def benchmarks_phase(params, cfg, seed: int) -> dict:
    """Phase 16c: [tables], the datasets, then videomme.evaluate (N = 1, the
    ASR prepended), worldsense.evaluate (the truncated video in
    <prefix>_errors.json; the score xlsx read back) and videommmu.evaluate
    (an MCQ and an open-ended item in one chunk, then the Adaptation item
    with its image), each through a QwenVLEngine at its own yaml
    (max_tokens cut to EVAL_MAX_TOKENS), item_batch EVAL_ITEM_BATCH: every
    item in the results, K1/K2/K3 per engine call as _check_waves says; VideoMMMU
    again decoding eagerly: each wave's token ids equal, every row
    EVAL_MAX_TOKENS long or ended by EOS. Returns VideoMMMU's data
    directory and results file, for the CLI step."""
    from open_o3_video_tpu_torch.eval import QwenVLEngine
    from open_o3_video_tpu_torch.utils.xlsx import read_xlsx

    t_phase = time.perf_counter()
    tables = tables_probe()
    dirs = bench_data(seed)
    files = {"videomme": f"{BENCH_DIR}/videomme_results.json",
             "worldsense": f"{BENCH_DIR}/worldsense",
             "videommmu": f"{BENCH_DIR}/videommmu_results.json"}
    kw = {"videomme": {"add_asr": True, "asr_dir": f"{dirs['videomme']}/asr"},
          "worldsense": {"asr_dir": f"{dirs['worldsense']}/asr"}, "videommmu": {}}
    for bench, config in BENCH_CONFIGS.items():
        model = QwenVLEngine(params, rt_shape=True, cfg=cfg, processor=O3VideoProcessor(),
                             **eval_config(config))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls, waves, graph, seconds = bench_run(bench, model, dirs[bench], files[bench],
                                                 **kw[bench])
        per_wave = _check_waves(bench, model, waves, cfg)
        rows = check_rows(bench, calls, EVAL_MAX_TOKENS, cfg.eos_token_id)
        if bench == "worldsense":
            with open(f"{files[bench]}_score.json") as f:
                results = json.load(f)
            with open(f"{files[bench]}_errors.json") as f:
                errors = json.load(f)
            xlsx = read_xlsx(f"{files[bench]}_score.xlsx")
            with open(f"{files[bench]}_rating.json") as f:
                overall = json.load(f)["overall"]["overall"]
            items = [r["video"] for r in results]
            ok = (items == [v[0] for v in BENCH_WS if v[0] != BENCH_WS_TRUNCATED]
                  and [e["video"] for e in errors] == [BENCH_WS_TRUNCATED]
                  and errors[0]["error"].startswith("OSError(")
                  and [r["video"] for r in xlsx] == items)
            extra = {"errors": [e["error"][:80] for e in errors], "xlsx_rows": len(xlsx),
                     "rating_overall": overall}
        else:
            with open(files[bench]) as f:
                written = json.load(f)
            results, errors = written["results"], written["errors"]
            key = "question_id" if bench == "videomme" else "id"
            items = [r[key] for r in results]
            want = ([f"{i:03d}-1" for i in range(len(BENCH_MME))] if bench == "videomme"
                    else [v[0] for v in BENCH_MMMU.values()])
            ok = items == want and errors == []
            extra = {"overall": written["overall"],
                     "preds": [r.get("pred_answer", r.get("parsed_pred")) for r in results]}
        log("bench", bench=bench, config=config, items=items, item_batch=EVAL_ITEM_BATCH,
            seconds=round(seconds, 3), rows=rows, per_wave=per_wave,
            grid_entries_per_wave=[w["grid_entries"] for w in waves], **extra,
            **_calls_line(model, 0), decode_ms_per_token=graph["ms_per_token"],
            peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
        if not ok:
            raise RuntimeError(f"{bench}: the results hold {items} with errors {errors}")
        if bench == "videommmu":
            # the Adaptation item (the last wave's one request) carries its image's rows
            mcq_entries, image_entries = waves[0]["grid_entries"][0], waves[-1]["grid_entries"][0]
            log("bench", bench=bench, grid_entries={"Perception": mcq_entries,
                                                    "Adaptation": image_entries})
            if image_entries != mcq_entries + 1:
                raise RuntimeError(f"VideoMMMU: the Adaptation request has {image_entries} grid "
                                   f"entries, the frames alone {mcq_entries}")
            model.engine.decode_graph = False  # again, decoding eagerly: the reference
            eager_calls, _, eager, eager_s = bench_run(
                bench, model, dirs[bench], f"{BENCH_DIR}/videommmu_results_eager.json")
            model.engine.decode_graph = True
            with open(f"{BENCH_DIR}/videommmu_results_eager.json") as f:
                same_file = json.load(f) == written
            log("bench", bench=bench, decode="eager", seconds=round(eager_s, 3),
                waves_compared=len(calls), eager_results_equal=same_file)
            decode_pair("videommmu evaluate", graph, eager, calls, eager_calls)
            if not same_file:
                raise RuntimeError("VideoMMMU: the eager evaluate's results differ from the "
                                   "graphed one's")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    log("bench", phase_seconds=round(time.perf_counter() - t_phase, 3), tables=tables)
    return {"data_dir": dirs["videommmu"], "results": files["videommmu"]}


def _cli_run(tag: str, args: list[str], out: str, write_s: float) -> dict:
    """`python -m open_o3_video_tpu_torch.eval.cli <args> --device cuda` in a
    subprocess; its results file."""
    cmd = [sys.executable, "-m", "open_o3_video_tpu_torch.eval.cli", *args, "--output", out,
           "--item_batch", str(EVAL_ITEM_BATCH), "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    tail = [x for x in proc.stdout.splitlines()
            if x.startswith(("[eval]", "V-STAR", "VideoMMMU", "1 items"))]
    log("eval", bench=f"cli {tag}", cmd=" ".join(cmd[1:]), rc=proc.returncode,
        seconds=round(seconds, 3), checkpoint_write_s=round(write_s, 3), lines=tail)
    if proc.returncode != 0:
        raise RuntimeError(f"the eval CLI ({tag}) failed ({proc.returncode}): "
                           f"{proc.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f)


def eval_cli_phase(params, cfg, results_file: str, bench: dict) -> None:
    """16a.6 and 16c's CLI step: `python -m open_o3_video_tpu_torch.eval.cli
    vstar --device cuda`, then `videommmu --device cuda`, each in a
    subprocess on phase 10's cut of the model written as a checkpoint
    directory (no tokenizer files), with vstar.yaml and video_mmmu.yaml cut
    as in 16a.2 and 16c. Each results file must hold the same items with the
    same keys as evaluate's (16a.2's V-STAR file, 16c's VideoMMMU file)."""
    small_cfg = _cut_cfg(cfg, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS)
    model = f"{EVAL_DIR}/model"
    t0 = time.perf_counter()
    CKPT.export_safetensors(_sub(params, NUMERICS_VIT_DEPTH, NUMERICS_TEXT_LAYERS), small_cfg, model)
    write_s = time.perf_counter() - t0
    for name in ("vstar.yaml", "video_mmmu.yaml"):
        with open(f"{EVAL_DIR}/cut_{name}", "w") as f:
            f.write("".join(f"{k}: {v}\n" for k, v in eval_config(name).items()))
    got = _cli_run("vstar", ["vstar", "--model_path", model, "--config", f"{EVAL_DIR}/cut_vstar.yaml",
                             "--anno", f"{EVAL_DIR}/vstar.json", "--video_folder",
                             f"{EVAL_DIR}/videos"], f"{EVAL_DIR}/cli_results.json", write_s)
    with open(results_file) as f:
        ref = json.load(f)
    same = ([r["vid"] for r in got] == [r["vid"] for r in ref]
            and [sorted(r) for r in got] == [sorted(r) for r in ref])
    log("eval", bench="cli vstar", same_items_and_keys=same, items=[r["vid"] for r in got])
    if not same:
        raise RuntimeError("the CLI's results file differs in items or keys from evaluate's")

    got = _cli_run("videommmu", ["videommmu", "--model_path", model, "--config",
                                 f"{EVAL_DIR}/cut_video_mmmu.yaml", "--data_dir", bench["data_dir"]],
                   f"{EVAL_DIR}/cli_videommmu.json", 0.0)
    with open(bench["results"]) as f:
        ref = json.load(f)
    same = (sorted(got) == sorted(ref)
            and [r["id"] for r in got["results"]] == [r["id"] for r in ref["results"]]
            and [sorted(r) for r in got["results"]] == [sorted(r) for r in ref["results"]]
            and got["errors"] == ref["errors"] == [])
    log("bench", bench="cli videommmu", same_items_and_keys=same,
        items=[r["id"] for r in got["results"]])
    if not same:
        raise RuntimeError("the VideoMMMU CLI's results file differs in items or keys from "
                           "evaluate's")


def eval_phase(params, cfg, seed: int) -> tuple[str, dict]:
    """Phase 16a on the 7B: the data, V-STAR, TVGBench, the MCQ item with
    TTS scoring; phase 16c (VideoMME, WorldSense, VideoMMMU); then the CLI
    for V-STAR and VideoMMMU. Returns the V-STAR results file (for 16b) and
    V-STAR's launch counts."""
    data = eval_data(seed)
    model, results_file, launches = vstar_phase(params, cfg, data)
    tvgbench_phase(model)
    del model
    torch.cuda.empty_cache()
    mcq_phase(params, cfg, data)
    gc.collect()
    torch.cuda.empty_cache()
    bench = benchmarks_phase(params, cfg, seed)
    eval_cli_phase(params, cfg, results_file, bench)
    return results_file, launches


def judge_eval_phase(judge, results_file: str) -> None:
    """16b: judge.evaluate_json on 16a's V-STAR results file (each empty
    answer_vqa filled with JUDGE_FILL_ANSWER, counted), the launch counts
    set to 0 just before: the overall block and K7's launches, > 0 on both
    routes."""
    from open_o3_video_tpu_torch.eval import evaluate_json

    with open(results_file) as f:
        items = json.load(f)
    filled = sum(not it["answer_vqa"] for it in items)
    for it in items:
        it["answer_vqa"] = it["answer_vqa"] or JUDGE_FILL_ANSWER
    scored = f"{EVAL_DIR}/vstar_results_judged.json"
    with open(scored, "w") as f:
        json.dump(items, f)
    lines: list[str] = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = evaluate_json(scored, judge, log=lines.append)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in K7_ROUTES}
    overall = stats["overall"]
    log("eval", bench="vstar-judge", items=len(items), answers_filled=filled,
        seconds=round(time.perf_counter() - t0, 3),
        vqa_scores=[it.get("VQA_score") for it in stats["scored_items"]],
        acc=overall["acc"], mAM=overall["mAM"], mLGM=overall["mLGM"],
        avg_all_rating=overall["avg_all_rating"], k7_launches=launches)
    log("eval", bench="vstar-judge", overall_block=lines[:12])
    if not all(launches.values()):
        raise RuntimeError(f"the judge's evaluate_json did not launch K7 on both routes: {launches}")
    if not all(np.isfinite(overall[k]) for k in ("acc", "mAM", "mLGM")):
        raise RuntimeError(f"evaluate_json gave non-finite composites: {overall}")


# ---- int4 serving ------------------------------------------------------------


def int4pack_yardstick(x, w):
    """torch._weight_int4pack_mm on K7's codes: unsigned codes + 8 in its
    own packing (N, K/2), bf16 scales, zero points 0, so it computes nearly
    K7's function (bf16 scales, its own sums). Returns (call, note): call is
    None where the card's torch lacks it or refuses these operands."""
    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, "torch has no _weight_int4pack_mm"
    t = (i4.unpack(w.w_p) + 8).t().contiguous()  # (N, K) codes 1..15
    packed = ((t[:, ::2] << 4) | t[:, 1::2]).to(torch.uint8)
    del t
    sz = torch.stack([w.scale, torch.zeros_like(w.scale)], dim=-1).to(torch.bfloat16).contiguous()
    try:  # a yardstick only: the port never calls it
        wp = torch._convert_weight_to_int4pack(packed, 8)
        call = lambda: torch._weight_int4pack_mm(x, wp, i4.KERNEL_GROUP, sz)  # noqa: E731
        call()
    except (RuntimeError, TypeError) as e:
        return None, f"refused: {str(e).splitlines()[0][:120]}"
    return call, "ok"


def int4_case(dev, gen, M, K, N) -> tuple:
    """bf16 x (M, K) and a group-128 int4 weight (K, N), outputs std ~0.25."""
    w = i4.quantize_weight_int4(torch.randn(K, N, generator=gen, device=dev) * (INT4_OUT_STD / K ** 0.5))
    return torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16), w


def int4_kernel_phase(dev, gen, prefill_rows, results) -> None:
    """K7 against its plain version at the main paths' shapes (INT4_CASES),
    each by the route its row count takes, with both yardsticks, the same
    bits from two calls, and the planted faults at the first case."""
    for case, M, K, N in INT4_CASES:
        M = M or prefill_rows
        name = i4.kernel_route(M)
        x, w = int4_case(dev, gen, M, K, N)
        wd = i4.dequantize(w, torch.bfloat16)
        ref = compare(name, lambda: i4.int4_matmul(x, w.w_p, w.scale, w.group),
                      lambda: i4.int4_matmul_torch(x, w.w_p, w.scale, w.group), None, results,
                      flops=2 * M * K * N, moved=K * N // 2 + 4 * N * K // 128 + 2 * M * K + 2 * M * N,
                      library_fn=lambda: torch.matmul(x, wd))
        del wd
        same = torch.equal(i4.int4_matmul(x, w.w_p, w.scale, w.group),
                           i4.int4_matmul(x, w.w_p, w.scale, w.group))
        call, note = int4pack_yardstick(x, w)
        pack_ms = statistics.median(time_ms(call)) if call is not None else None
        pack_rel = None if call is None else _agreement(call().float(), ref.float())[0]
        log("kernels", name=name, case=case, M=M, K=K, N=N, groups=K // w.group,
            int4pack_ms=None if pack_ms is None else round(pack_ms, 4), int4pack=note,
            int4pack_vs_plain_rel=pack_rel, same_bits_twice=same)
        if not same:
            raise RuntimeError(f"{name} {case}: two calls gave different bits")
        results[name].setdefault("int4pack_ms", pack_ms)
        if case == INT4_CASES[0][0]:
            p = w.w_p.to(torch.int32)
            swapped = (((p & 0xF) << 4) | ((p >> 4) & 0xF)).to(torch.int8)
            planted("int4_matmul", "nibbles swapped",
                    i4.int4_matmul_torch(x, swapped, w.scale, w.group), ref, None)
            planted("int4_matmul", "scales one group off",
                    i4.int4_matmul_torch(x, w.w_p, torch.roll(w.scale, 1, 0), w.group), ref, None)
        del x, w, ref, call
        torch.cuda.empty_cache()


def probe_phase(dev, gen, results) -> dict:
    """The K7a probes and K7 at the TPU scripts' shape against their plain
    versions, then their own path: each chained over PROBE_CHAIN distinct
    weights as profile_int4_kernel_parts.py chains them (x <- tanh(x +
    1e-3 * y[:, :K])), the counts reset before and read after. Returns the
    probes' launch counts."""
    M, K, N = PROBE_M, PROBE_K, PROBE_N
    x, w = int4_case(dev, gen, M, K, N)
    xr = x.float()
    xs = (INT4_OUT_STD / (w.w_p.float().std().item() * (K / 2) ** 0.5) * xr).to(torch.bfloat16)
    codes = i4.unpack(w.w_p)
    xc = (INT4_OUT_STD / (codes.float().std().item() * K ** 0.5) * xr).to(torch.bfloat16)
    packed_bf16, codes_bf16 = w.w_p.to(torch.bfloat16), codes.to(torch.bfloat16)
    del codes
    compare("int4_matmul_stream", lambda: i4.int4_matmul_stream(xs, w.w_p),
            lambda: i4.int4_matmul_stream_torch(xs, w.w_p), None, results,
            flops=2 * M * (K // 2) * N, moved=K * N // 2 + M * K + 2 * M * N,
            library_fn=lambda: torch.matmul(xs[:, :K // 2], packed_bf16))
    compare("int4_matmul_convert", lambda: i4.int4_matmul_convert(xc, w.w_p),
            lambda: i4.int4_matmul_convert_torch(xc, w.w_p), None, results,
            flops=2 * M * K * N, moved=K * N // 2 + 2 * M * K + 2 * M * N,
            library_fn=lambda: torch.matmul(xc, codes_bf16))
    wd = i4.dequantize(w, torch.bfloat16)
    compare("int4_matmul", lambda: i4.int4_matmul(x, w.w_p, w.scale, w.group),
            lambda: i4.int4_matmul_torch(x, w.w_p, w.scale, w.group), None, results,
            flops=2 * M * K * N, moved=K * N // 2 + 4 * N * K // 128 + 2 * M * K + 2 * M * N,
            library_fn=lambda: torch.matmul(x, wd))
    del packed_bf16, codes_bf16, wd
    ws = [w] + [int4_case(dev, gen, 1, K, N)[1] for _ in range(PROBE_CHAIN - 1)]
    calls = {"int4_matmul_stream": lambda x, w: i4.int4_matmul_stream(x, w.w_p),
             "int4_matmul_convert": lambda x, w: i4.int4_matmul_convert(x, w.w_p),
             "int4_matmul": lambda x, w: i4.int4_matmul(x, w.w_p, w.scale, w.group)}
    torch.cuda.synchronize()
    kernels.reset_launches()
    chained = {}
    for name, call in calls.items():
        h = xs if name == "int4_matmul_stream" else x
        t0 = time.perf_counter()
        for wi in ws:
            h = torch.tanh(h + call(h, wi)[:, :K] * 1e-3)
        torch.cuda.synchronize()
        chained[name] = round(1e3 * (time.perf_counter() - t0) / PROBE_CHAIN, 4)
    launches = {name: kernels.LAUNCHES[name] for name in PROBE_KERNELS}
    log("kernels", probe_chain=PROBE_CHAIN, ms_per_chained_call_host_clock=chained, launches=launches)
    if not all(launches.values()):
        raise RuntimeError(f"a probe never launched: {launches}")
    del ws, x, xs, xc, w
    torch.cuda.empty_cache()
    return launches


def k7_expected(engine, layers: int, sched: dict) -> dict:
    """K7's launches by route in the engine's last generate, from its
    scheduler counters (``decode_run``): each prefill forward (a prompt, a
    chunk, a prefix block or a suffix admission, each over more than 64
    rows) runs the 7 * layers decoder matmuls on the wgmma route; each
    admission its lm_head at the last positions (M = its rows) on the
    mma.sync one; then 7 * layers + 1 per decode step that ran on the
    mma.sync route (a replayed step counts its kernels)."""
    steps = engine.decode_steps + engine.decode_steps_wasted
    return {"int4_matmul": sched["admissions"] + (7 * layers + 1) * steps,
            "int4_matmul_wgmma": 7 * layers * sched["prefills"]}


def int4_slice_phase(qparams, cfg, reqs, sampling, bf16_logits) -> dict:
    """The 7B video slice with its decoder in int4 through the same engine.
    Returns the launch counts; K7's must match k7_expected route by route."""
    log("int4", weights_gib=round(quant.param_bytes(qparams) / 2**30, 3), params=P.count(qparams))
    engine = InferenceEngine(qparams, cfg)
    outs, launches, decode = slice_phase(engine, reqs, sampling, INT4_SLICE_KERNELS)
    expected = k7_expected(engine, cfg.text.num_hidden_layers, decode["scheduler"])
    got = {name: launches[name] for name in K7_ROUTES}
    log("int4", first_token_ids=[o["token_ids"][:8] for o in outs], k7_launches=got,
        expected=expected, scheduler=dict(decode["scheduler"]))
    if got != expected:
        raise RuntimeError(f"K7 launched {got} times by route, expected {expected}: "
                           "a decoder matmul did not take its route")
    eager_pair("int4 slice", qparams, cfg, reqs, sampling, outs, decode)
    del engine
    kernel = _vision_and_logits(qparams, cfg, reqs, "auto")[1]
    plain = _vision_and_logits(qparams, cfg, reqs, "torch")[1]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = _vision_and_logits(_cast(qparams, torch.float32), cfg32, reqs, "torch")[1]
    torch.cuda.empty_cache()
    rel_k, cos_k = _agreement(kernel, ref)
    rel_p, cos_p = _agreement(plain, ref)
    rel_b, cos_b = _agreement(kernel, bf16_logits)
    log("numerics", what="int4 prefill logits", kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k,
        plain_vs_f32_rel=rel_p, plain_vs_f32_cos=cos_p, max_ratio=SLICE_REL_RATIO,
        int4_vs_bf16_rel=rel_b, int4_vs_bf16_cos=cos_b)
    if not (torch.isfinite(kernel).all() and rel_k <= SLICE_REL_RATIO * rel_p):
        raise RuntimeError(f"int4 logits: the K7 path is further from float32 than the plain int4 "
                           f"path ({rel_k} vs {rel_p})")
    return launches


def judge_phase(dev, seed, results_file: str) -> dict:
    """Qwen2.5-72B-Instruct in int4 on the card through EngineJudge.batch,
    twice, then (16b) evaluate_json on ``results_file``. Returns K7's launch
    counts by route in the first call."""
    cfg = Qwen25VLConfig.from_hf_dict(QWEN25_72B_INSTRUCT_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = P.init(cfg, seed, dev, quantize_text="int4")
    torch.cuda.synchronize()
    log("judge", model="Qwen2.5-72B-Instruct", layers=cfg.text.num_hidden_layers,
        hidden=cfg.text.hidden_size, params=P.count(params),
        init_s=round(time.perf_counter() - t0, 3),
        weights_gib=round(quant.param_bytes(params) / 2**30, 3),
        init_peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    judge = EngineJudge(params, max_new_tokens=JUDGE_NEW_TOKENS, cfg=cfg,
                        processor=O3VideoProcessor())
    engine = judge.engine
    engine.generate([judge._request(*JUDGE_JOBS[0])],
                    dataclasses.replace(judge.sampling, max_tokens=2))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(engine) as graph_tokens:  # for the graphed/eager comparison
        scores, decode = decode_run(engine, lambda: judge.batch(list(JUDGE_JOBS)))
    e2e = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES[name] for name in K7_ROUTES}
    k3_launches = kernels.LAUNCHES["flash_attention_gqa"]
    expected = k7_expected(engine, cfg.text.num_hidden_layers, decode["scheduler"])
    st = engine.stage_seconds
    log("judge", jobs=len(JUDGE_JOBS), prompt_tokens=[len(judge._request(*j).input_ids) for j in JUDGE_JOBS],
        prefill_ms=round(1e3 * st["prefill"], 3),
        decode_ms_per_token=decode["ms_per_token"], decode_capture_ms=decode["capture_ms"],
        decode_steps=engine.decode_steps, e2e_s=round(e2e, 3),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), scores=scores,
        k7_launches=launches, expected=expected, k3_launches=k3_launches,
        scheduler=dict(decode["scheduler"]))
    if launches != expected:
        raise RuntimeError(f"K7 launched {launches} times by route in the judge call, "
                           f"expected {expected}")
    engine.decode_graph = False  # the second call decodes eagerly: the reference
    with recording(engine) as eager_tokens:
        again, eager = decode_run(engine, lambda: judge.batch(list(JUDGE_JOBS)))
    decode_pair("judge", decode, eager, graph_tokens, eager_tokens)
    log("judge", identical_scores_across_calls=again == scores, scores_again=again)
    if again != scores:
        raise RuntimeError("two judge calls gave different scores")
    engine.decode_graph = True
    judge_eval_phase(judge, results_file)
    del judge, engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Phase 17, the serving scheduler. V-STAR's shape: 2 videos of 16 frames, 5
# queries each, question tails of these many bytes (the ByteTokenizer's
# tokens). Beside them 4 text-only prompts of these lengths. The 10 video
# rows' prefixes and the 3000-token text share one prompt bucket (4096), so
# they form one group of 11 requests for 8 slots: it refills, and its
# 48-column ring wraps; the 300-byte tail makes the suffix region ~313
# columns wide, so the other suffixes are left-padded.
SCHED_TAILS = ((20, 27, 34, 41, 300), (23, 30, 37, 44, 48))
SCHED_TEXT = (500, 1200, 2000, 3000)
SCHED_SLOTS, SCHED_SEGMENT, SCHED_TOKENS = 8, 16, 48
# 17b: each prefix-cached row's first token's log-probability against the
# log-probability of the same token under a plain prefill of its whole
# prompt (no prefix block, one batch): they may differ by bf16 rounding
# only, since the block and the whole prompt's prefill compute the same K/V
# in matmuls of other shapes. Planted faults (the other video's block, a
# zeroed block) must exceed the bound.
SCHED_LOGP_BOUND = 0.15
# 17b's second reading: each prefix block's K/V against a plain prefill's
# K/V of the same columns (its family's first request alone, the whole
# prompt), relative L2 error over every layer of k and v. The sound block is
# the same function in matmuls of other shapes, so bf16 rounding only
# (expected <= 0.03); a block moved one column right holds each column's
# neighbour (expected >= 0.3), which the first reading passes (0.094 under
# 0.15). Stated before this reading's first run.
SCHED_KV_REL_BOUND = 0.1
# K3's suffix-admission case: the family's prefix block is this many columns
# shorter than the group's prefix region, so the rows hold a hole
# [0, SCHED_HOLE) before the block, as a prefix group of families with
# prefixes of other lengths lays them out.
SCHED_HOLE = 40
# 17c: two 1000-token requests and an 8000-token one in one group (one
# prompt bucket), 2 slots, chunks of 2048 tokens, segments of 8 steps; the
# first request stops at its EOS (the token an eager run of the same group
# emits at step 5: a row's tokens depend on the batch it decodes in, whose
# shape sets K4's split plan), so the long one is admitted while the second
# decodes.
SCHED_CHUNK_LENS = (1000, 1000, 8000)
SCHED_CHUNK, SCHED_CHUNK_SEGMENT = 2048, 8
# 17d: the KV budget admits this many slots of the 11-request group.
SCHED_KV_SLOTS = 3


def scheduler_requests(proc, cfg, seed: int) -> list[Request]:
    """17a's 14 requests: per video one patch array shared by its 5 queries
    (the same system prompt and frames, then a tail), then the text-only
    prompts."""
    rng = np.random.default_rng(seed + 17)
    reqs = []
    for v, tails in enumerate(SCHED_TAILS):
        frames = rng.integers(0, 256, size=(N_FRAMES, 3, FRAME_H, FRAME_W), dtype=np.uint8)
        vis = proc.process_images(list(frames))
        frame_prompt = "".join(
            f"Frame {j + 1} at {round(j / FPS, 1)} second: "
            "<|vision_start|><|image_pad|><|vision_end|>\n" for j in range(N_FRAMES))
        for q, n in enumerate(tails):
            tail = f"Q{v}{q}: " + "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n - 5))
            prompt = proc.apply_chat_template([
                {"role": "system", "content": [{"type": "text", "text": SYSTEM_PROMPT}]},
                {"role": "user", "content": [{"type": "text", "text": frame_prompt},
                                             {"type": "text", "text": tail}]},
            ], add_generation_prompt=True)
            x = proc(prompt, images=list(frames), precomputed_vision=vis)
            reqs.append(Request(input_ids=x.input_ids, pixel_patches=vis.pixel_patches,
                                grid_thw=vis.grid_thw, vision_token_id=cfg.image_token_id))
    for n in SCHED_TEXT:
        reqs.append(Request(input_ids=rng.integers(32, 127, size=n).tolist()))
    return reqs


def scheduler_run(engine, reqs, sampling, tag: str) -> tuple[list[dict], dict]:
    """One generate of ``reqs`` through ``engine`` (``decode_run``), with the
    peak memory and the launches of the slice's kernels; logs the call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, run = decode_run(engine, lambda: engine.generate(reqs, sampling, return_logprobs=True))
    run["seconds"] = round(time.perf_counter() - t0, 3)
    run["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    run["kernel_launches"] = {n: kernels.LAUNCHES[n] for n in SLICE_KERNELS + LONG_KERNELS}
    run["groups"] = list(engine.groups)
    st = engine.stage_seconds
    log("sched", run=tag, decode_graph=engine.decode_graph, requests=len(reqs),
        seconds=run["seconds"], stage_seconds={k: round(v, 4) for k, v in st.items()},
        capture_ms=run["capture_ms"], decode_ms_per_token=run["ms_per_token"],
        decode_steps=run["steps"], wasted_steps=run["wasted"], peak_mem_gib=run["peak_mem_gib"],
        **run["scheduler"])
    log("sched", run=tag, groups=run["groups"], launches=run["kernel_launches"])
    vocab = engine.cfg.text.vocab_size
    for o in outs:
        if not 1 <= len(o["token_ids"]) <= sampling.max_tokens or not all(
                0 <= t < vocab for t in o["token_ids"]):
            raise RuntimeError(f"{tag}: a bad output row {o['token_ids'][:8]}...")
        if not all(np.isfinite(o["logprobs"])):
            raise RuntimeError(f"{tag}: a non-finite log-probability")
    return outs, run


def k4_ring_case(dev, cfg, gen) -> None:
    """K4 at query position T on a wrapped ring, as the ring step calls it:
    two rows over T = 32768 + 48 columns, the write head at ring column 10,
    row 0's valid ring columns on both sides of it (it wrapped), row 1
    left-padded and past the head only. K4 against its plain version at
    the kernels' bounds; the plain version with the columns past the head
    dropped (what a mask of the written columns would read) must fail
    them."""
    t = cfg.text
    L, ring, head = 32768, 48, 10
    T = L + ring
    k, v = _layer_views(dev, gen, cfg, 2, T, T, torch.bfloat16)
    q = torch.randn((2, 1, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = torch.full((2, 1), T, dtype=torch.int32, device=dev)
    valid = torch.zeros((2, T), dtype=torch.int32, device=dev)
    valid[0, :L] = 1
    valid[0, L:L + head + 1] = 1
    valid[0, L + head + 20:] = 1
    valid[1, 3000:L] = 1
    valid[1, L + head:L + head + 1] = 1
    valid[1, L + 30:] = 1
    results: dict = {}
    mask = causal_mask(pos, valid)
    ref = compare("decode_attention_gqa", lambda: da.decode_attention_gqa(q, k, v, pos, valid),
                  lambda: da.decode_attention_gqa_torch(q, k, v, pos, valid), None, results,
                  flops=4 * int(valid.sum()) * t.num_attention_heads * t.head_dim,
                  moved=nbytes(q, k, v, pos, valid, q), case="ring wrapped, q at T",
                  library_fn=lambda: sdpa_masked(q, k, v, mask))
    written = valid.clone()
    written[:, L + head + 1:] = 0
    a = agreement(da.decode_attention_gqa_torch(q, k, v, pos, written), ref, None)
    log("kernels", name="decode_attention_gqa", planted_fault="columns past the write head "
        "dropped", max_abs_err=a["max_abs_err"], bound=a["bound"], rel_l2=a["rel_l2"],
        rejected=not a["ok"])
    if a["ok"]:
        raise RuntimeError("K4's bound does not reject a read that stops at the write head")
    del k, v, mask
    torch.cuda.empty_cache()


def k3_suffix_case(dev, cfg, gen, engine, reqs) -> None:
    """K3 at a suffix admission's layout, laid out by the engine's own
    ``_suffix_rows`` for 17a's prefix group: video 1's 5 queries, their
    suffixes left-padded into S columns at [P, P + S), their prefix block
    SCHED_HOLE columns short of P (a hole [0, P - pl) before it), queries
    at columns P.. (cache offset P), the mask that validity ANDed with the
    written columns (< P + S) over a cache of T = P + S + SCHED_TOKENS
    columns. K3 against its plain version at the kernels' bounds, on the
    real suffix rows; then planted faults, each the plain version with the
    layout wrong, must fail them: the queries at their suffix index (the
    offset P dropped), the suffix's left pad read as valid, the block's
    mask one column to the left (a hole column read, the block's last
    column dropped)."""
    t = cfg.text
    pls = engine._detect_prefixes(reqs)
    group = [i for i, pl in enumerate(pls) if pl]
    P = max(pls[i] for i in group)
    S = max(len(reqs[i].input_ids) - pls[i] for i in group)
    T = P + S + SCHED_TOKENS
    fam = [reqs[i] for i in group if reqs[i].pixel_patches is reqs[group[-1]].pixel_patches]
    pl = P - SCHED_HOLE
    if max(len(r.input_ids) for r in fam) - pl > S:
        raise RuntimeError(f"K3 suffix case: a suffix of the family does not fit {S} columns")
    attn_rows = engine._suffix_rows(fam, pl, P, S, T)[3]
    n = len(fam)
    valid = torch.from_numpy(attn_rows).to(dev).int()
    valid[:, P + S:] = 0  # what the layer masks: columns past the write head
    # every column finite: K3 reads whole key tiles (a masked column's
    # weight is 0), and the engine's caches hold zeros or older tokens there
    k, v = _layer_views(dev, gen, cfg, n, T, T, torch.bfloat16)
    q = torch.randn((n, S, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = (P + torch.arange(S, dtype=torch.int32, device=dev)).expand(n, S).contiguous()
    keep = valid[:, P:P + S] != 0
    mask = causal_mask(pos, valid)
    results: dict = {}
    ref = compare("flash_attention_gqa", lambda: fa.flash_attention_gqa(q, k, v, pos, valid),
                  lambda: fa.flash_attention_gqa_torch(q, k, v, pos, valid), keep, results,
                  flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
                  moved=nbytes(q, k, v, pos, valid, q),
                  library_fn=lambda: sdpa_masked(q, k, v, mask),
                  case=f"suffix admission: {n} rows, S={S} at offset P={P}, block of {pl}, T={T}")
    padded, shifted = valid.clone(), valid.clone()
    padded[:, P:P + S] = 1
    shifted[:, P - pl - 1:P - 1] = 1
    shifted[:, P - 1] = 0
    for fault, fpos, fvalid in (("queries at their suffix index (offset P dropped)", pos - P, valid),
                                ("the suffix's left pad read as valid", pos, padded),
                                ("the block's mask one column left", pos, shifted)):
        planted("flash_attention_gqa", fault,
                fa.flash_attention_gqa_torch(q, k, v, fpos, fvalid), ref, keep)
    del k, v, q, mask
    torch.cuda.empty_cache()


def first_token_gap(outs, ref_logp) -> float:
    """The largest gap, over rows, between a row's first token's
    log-probability and the reference's log-probability of that token."""
    return max(abs(o["logprobs"][0] - float(ref_logp[j, o["token_ids"][0]]))
               for j, o in enumerate(outs))


@torch.inference_mode()
def _prefill_cache(params, cfg, req) -> dict:
    """The KV cache of ``req``'s whole prompt, prefilled alone (no prefix
    block, no padding) as the engine prefills a plain row."""
    dev = params["text"]["embed_tokens"].device
    L = len(req.input_ids)
    ids, mask, position_ids, _ = left_padded_rows(cfg, [req], L)
    vis = encode_vision(params, cfg, torch.as_tensor(req.pixel_patches, device=dev),
                        np.asarray(req.grid_thw))
    embeds = merge_vision_embeddings_by_index(
        embed_tokens(params, torch.from_numpy(ids).to(dev)), vis,
        torch.from_numpy(build_vision_row_index(ids, cfg.image_token_id, [0])).to(dev))
    cache = init_kv_cache(cfg.text, 1, L, dtype=cfg.dtype, device=dev)
    text_forward(params["text"], cfg.text, embeds, torch.from_numpy(position_ids).to(dev),
                 attn_valid=torch.from_numpy(mask).to(dev), cache=cache)
    return cache


def prefix_kv_gap(blocks, refs) -> float:
    """17b's second reading: the largest relative L2 error, over the
    blocks, of a block's k and v (all layers) against ``refs``, the same
    columns of a plain prefill."""
    gaps = []
    for key, block in blocks.items():
        pl = block["k"].shape[2]
        num = sum(((block[n].float() - refs[key][n][:, :, :pl].float()) ** 2).sum()
                  for n in ("k", "v"))
        den = sum((refs[key][n][:, :, :pl].float() ** 2).sum() for n in ("k", "v"))
        gaps.append((num / den).sqrt().item())
    return max(gaps)


@torch.inference_mode()  # the blocks are inference tensors
def prefix_faults(engine, reqs, ref_logp, sampling, kv_refs) -> tuple[dict, dict]:
    """17b's planted faults in 17a's cached prefix blocks (2 of equal shape,
    one per video): one generate of the cached rows' first token through
    the same engine with the blocks as they are (every block a hit), then
    with the two videos' blocks swapped, with each block's columns moved
    one to the right (its last column lost, the first twice), and with the
    blocks zeroed. Returns each run's first_token_gap (the caller holds the
    sound one within SCHED_LOGP_BOUND and the swapped and zeroed ones past
    it) and the second reading, prefix_kv_gap against ``kv_refs``, of the
    sound and the shifted blocks (the caller holds the sound one within
    SCHED_KV_REL_BOUND and the shifted one past it)."""
    first = SamplingParams(**{**vars(sampling), "max_tokens": 1})
    blocks = engine._prefix_kv
    a, b = list(blocks)
    if blocks[a]["k"].shape != blocks[b]["k"].shape:
        raise RuntimeError("17b: the two videos' prefix blocks differ in shape")

    def gap() -> float:
        built = engine.counters["prefix_blocks"]
        outs = engine.generate(reqs, first, return_logprobs=True)
        if engine.counters["prefix_blocks"] != built:
            raise RuntimeError("17b: a planted block was rebuilt, not served")
        return first_token_gap(outs, ref_logp)

    gaps = {"sound": gap()}
    kv = {"sound": prefix_kv_gap(blocks, kv_refs)}
    blocks[a], blocks[b] = blocks[b], blocks[a]
    gaps["the other video's block"] = gap()
    blocks[a], blocks[b] = blocks[b], blocks[a]
    for blk in blocks.values():
        for x in blk.values():
            x[:, :, 1:] = x[:, :, :-1].clone()
    gaps["block one column right"] = gap()
    kv["block one column right"] = prefix_kv_gap(blocks, kv_refs)
    for blk in blocks.values():
        for x in blk.values():
            x.zero_()
    gaps["zeroed block"] = gap()
    return gaps, kv


def scheduler_phase(params, cfg, proc, seed: int) -> dict:
    """Phase 17: K4 on a wrapped ring and K3 at a suffix admission's layout;
    17a one generate of 14 requests through 8 slots, graphed and eagerly
    (equal token ids); 17b the same with the prefix cache off (prefill
    seconds of both, the share of equal rows), and the prefix-cached rows'
    first-token log-probabilities against a plain prefill's, sound and
    with planted block faults; 17c a long admission in chunks while a slot
    decodes, graphed and eagerly; 17d the KV budget. Returns 17a's launch
    counts."""
    t_phase = time.perf_counter()
    dev = params["text"]["embed_tokens"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    k4_ring_case(dev, cfg, gen)
    reqs = scheduler_requests(proc, cfg, seed)
    sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=SCHED_TOKENS)
    knobs = dict(max_slots=SCHED_SLOTS, decode_segment=SCHED_SEGMENT)
    log("sched", requests=len(reqs), prompt_tokens=[len(r.input_ids) for r in reqs],
        max_slots=SCHED_SLOTS, decode_segment=SCHED_SEGMENT, new_tokens=SCHED_TOKENS)
    engine = InferenceEngine(params, cfg, **knobs)
    k3_suffix_case(dev, cfg, gen, engine, reqs)

    # 17a
    outs, graph = scheduler_run(engine, reqs, sampling, "17a")
    sched, launches = graph["scheduler"], graph["kernel_launches"]
    want = {"prefix_blocks": 2, "tower_passes": 2}
    if any(sched[k] != n for k, n in want.items()) or sched["ring_wraps"] < 1 or sched[
            "admissions"] < 2:
        raise RuntimeError(f"17a: expected {want}, a ring wrap and admissions > 1: {sched}")
    if not all(launches[n] for n in SLICE_KERNELS):
        raise RuntimeError(f"17a: a kernel of the path never launched: {launches}")
    eager_engine = InferenceEngine(params, cfg, decode_graph=False, **knobs)
    eager_outs, eager = scheduler_run(eager_engine, reqs, sampling, "17a eager")
    decode_pair("scheduler 17a", graph, eager, [o["token_ids"] for o in outs],
                [o["token_ids"] for o in eager_outs])
    del eager_engine

    # 17b
    plain_engine = InferenceEngine(params, cfg, prefix_cache_min=0, **knobs)
    plain_outs, plain = scheduler_run(plain_engine, reqs, sampling, "17b prefix cache off")
    del plain_engine
    same_rows = sum(a["token_ids"] == b["token_ids"] for a, b in zip(outs, plain_outs))
    first_same = sum(a["token_ids"][0] == b["token_ids"][0] for a, b in zip(outs, plain_outs))
    cached = [i for i, pl in enumerate(engine._detect_prefixes(reqs)) if pl]
    cached_reqs = [reqs[i] for i in cached]
    ref_logp = torch.log_softmax(_vision_and_logits(params, cfg, cached_reqs, "auto")[1],
                                 dim=-1).cpu()
    kv_refs = {}
    for r in cached_reqs:
        key = engine._prefix_key(r, engine._detect_prefixes(reqs)[reqs.index(r)])
        if key in engine._prefix_kv and key not in kv_refs:
            kv_refs[key] = _prefill_cache(params, cfg, r)
    n_blocks = len(kv_refs)
    if n_blocks != len(engine._prefix_kv):
        raise RuntimeError(f"17b: {n_blocks} plain prefills for {len(engine._prefix_kv)} blocks")
    faults, kv_gaps = prefix_faults(engine, cached_reqs, ref_logp, sampling, kv_refs)
    gaps = {"17a": first_token_gap([outs[i] for i in cached], ref_logp),
            "prefix cache off": first_token_gap([plain_outs[i] for i in cached], ref_logp),
            **faults}
    del engine, kv_refs
    log("sched", run="17b", prefill_s={"prefix cache": graph["prefill_s"], "off": plain["prefill_s"]},
        vision_s={"prefix cache": graph["vision_s"], "off": plain["vision_s"]},
        prefill_ratio=round(graph["prefill_s"] / max(plain["prefill_s"], 1e-9), 3),
        identical_rows=f"{same_rows}/{len(reqs)}", first_token_equal=f"{first_same}/{len(reqs)}",
        prefix_cached_rows=len(cached), first_logprob_gap_to_plain_prefill=gaps,
        bound=SCHED_LOGP_BOUND)
    log("sched", run="17b", prefix_kv_rel_l2_to_plain_prefill=kv_gaps, bound=SCHED_KV_REL_BOUND,
        blocks=n_blocks)
    sound = ("17a", "prefix cache off", "sound")
    if len(cached) != 10 or any(gaps[k] > SCHED_LOGP_BOUND for k in sound) or any(
            gaps[k] <= SCHED_LOGP_BOUND for k in ("the other video's block", "zeroed block")):
        raise RuntimeError(f"17b: {len(cached)} prefix-cached rows, first-token log-probability "
                           f"gaps {gaps} against the bound {SCHED_LOGP_BOUND} (the sound runs "
                           f"within it, the planted faults past it)")
    if not kv_gaps["sound"] <= SCHED_KV_REL_BOUND < kv_gaps["block one column right"]:
        raise RuntimeError(f"17b: prefix blocks' K/V against a plain prefill {kv_gaps}, bound "
                           f"{SCHED_KV_REL_BOUND} (the sound block within it, the shifted one "
                           "past it)")

    # 17c
    rng = np.random.default_rng(seed + 171)
    long_reqs = [Request(input_ids=rng.integers(32, 127, size=n).tolist())
                 for n in SCHED_CHUNK_LENS]
    chunk_knobs = dict(max_slots=2, decode_segment=SCHED_CHUNK_SEGMENT,
                       prefill_chunk=SCHED_CHUNK, prompt_buckets=(8192,))
    probe = InferenceEngine(params, cfg, decode_graph=False, **chunk_knobs).generate(
        long_reqs, sampling)[0]["token_ids"]
    stop_cfg = dataclasses.replace(cfg, eos_token_id=probe[EARLY_STOP_STEP])
    runs = {}
    for graphed in (True, False):
        engine = InferenceEngine(params, stop_cfg, decode_graph=graphed, **chunk_knobs)
        runs[graphed] = scheduler_run(engine, long_reqs, sampling,
                                      "17c graph" if graphed else "17c eager")
        del engine
    (c_outs, c_graph), (ce_outs, c_eager) = runs[True], runs[False]
    decode_pair("scheduler 17c", c_graph, c_eager, [o["token_ids"] for o in c_outs],
                [o["token_ids"] for o in ce_outs])
    between = c_graph["scheduler"]["interleaved_segments"]
    log("sched", run="17c", eos=stop_cfg.eos_token_id, lengths=[len(o["token_ids"]) for o in c_outs],
        segments_between_chunks=between, prefill_s=c_graph["prefill_s"])
    if between < 3 or c_outs[0]["token_ids"][-1] != stop_cfg.eos_token_id:
        raise RuntimeError(f"17c: {between} segments between chunks (expected >= 3), first row "
                           f"{c_outs[0]['token_ids']}")

    # 17d
    t = cfg.text
    big = max(graph["groups"], key=lambda g: g["requests"])
    per_col = 2 * t.num_hidden_layers * t.num_key_value_heads * t.head_dim * 2  # bf16
    budget_gb = (SCHED_KV_SLOTS + 0.5) * per_col * big["columns"] / 1e9
    engine = InferenceEngine(params, cfg, max_kv_gb=budget_gb, **knobs)
    kv_outs, kv = scheduler_run(engine, reqs, sampling, f"17d max_kv_gb={budget_gb:.4f}")
    del engine
    capped = [g for g in kv["groups"] if g["columns"] == big["columns"]
              and g["requests"] == big["requests"]]
    over = [g for g in kv["groups"] if g["arena_bytes"] > budget_gb * 1e9]
    same_rows = sum(a["token_ids"] == b["token_ids"] for a, b in zip(outs, kv_outs))
    log("sched", run="17d", budget_gb=budget_gb, slots=[g["slots"] for g in kv["groups"]],
        arena_gib=[round(g["arena_bytes"] / 2**30, 4) for g in kv["groups"]],
        identical_rows_to_17a=f"{same_rows}/{len(reqs)}")
    if [g["slots"] for g in capped] != [SCHED_KV_SLOTS] or over:
        raise RuntimeError(f"17d: the budget's group ran {capped}, groups over budget {over}")
    log("sched", phase_seconds=round(time.perf_counter() - t_phase, 3))
    return launches


# Phase 18: speculative decoding. 18a greedy on the slice's first video
# request; 18b GSPO's rollouts through the sampled path (worst: random-init
# sampling, which the probe must revert; replay: a cycling grounded trace);
# 18c greedy at run (a)'s length, whose verify blocks run K4 at S = K1.
SPEC_DRAFT = 7
SPEC_K1 = SPEC_DRAFT + 1
SPEC_TOKENS = 64
# Where the spec tokens first differ from the plain path's, the plain
# step's top-2 logit gap must be at most this: the bf16 verify block sums in
# other shapes than a one-token step, so it may resolve a near-tie the other
# way (the JAX engine documents the same), but not a clear winner. Logits of
# the random-init 7B have std ~1.2 over 152064 entries, so their top-2 gap
# is ~0.25 on average; the block-vs-step difference in a logit is ~0.05.
# Stated before phase 18's first run.
SPEC_TIE_GAP = 0.25
# 18b replays this many trace tokens a row (the bench's max_completion_length
# + 16).
SPEC_TRACE_EXTRA = 16
# The kernel cases at the verify blocks' shapes: K4 (B, S = K1, T, stored
# dtype) and K3 over a sampled-spec arena of GSPO's geometry: 4 rows of the
# 3032-token prompt, 768 tokens, spec_surplus 1024, K1, and K1 scratch
# columns; the block at decode column SPEC_K3_CURSOR, holes in half the
# decode columns before it.
SPEC_K4_CASES = ((1, 40000, torch.float8_e4m3fn), (4, 33000, torch.bfloat16))
# The fp8 case's block keys score this much with the block's queries (the
# background keys ~N(0, 1)): 8 of them outweigh its 40000 other keys.
SPEC_BLOCK_SCORE = 10.0
SPEC_GSPO_PROMPT, SPEC_K3_CURSOR = 3032, 800


def reasoning_trace_tokens(n, row, vocab, eos):
    """A synthetic grounded-reasoning trace as a token stream: a copy of the
    JAX bench's ``bench.py:_reasoning_trace_tokens`` (the port imports
    nothing of that package): prose and ``<obj>..</obj><box>[..]</box>at<t>
    ..</t>s`` citations in ``<think>``/``<answer>`` framing, split at word
    and punctuation, each piece hashed to a stable id; rows differ in
    objects, times and boxes, not in skeleton."""
    import zlib

    rng = np.random.default_rng(1234 + row)
    objs = ["person", "red ball", "dog", "table", "car", "woman", "cup",
            "child", "door", "bicycle"]
    verbs = ["is visible", "appears", "moves left", "picks it up",
             "walks past", "is occluded", "enters the frame", "stops"]
    parts = ["<think>", "Let me examine the video step by step.\n"]
    while sum(len(p.split()) for p in parts) < 2 * n:  # overfill, trim below
        o = objs[rng.integers(len(objs))]
        v = verbs[rng.integers(len(verbs))]
        a, b = rng.integers(0, 400, 2)
        w, h = rng.integers(40, 300, 2)
        t = rng.integers(0, 300) / 10
        parts.append(f"The <obj>{o}</obj><box>[{a},{b},{a + w},{b + h}]</box>"
                     f"at<t>{t}</t>s {v}, so ")
    parts.append("</think><answer>a red ball</answer>")
    pieces = [p for p in re.split(r"(\d+|\W)", "".join(parts)) if p and p != " "]
    toks = [1000 + (zlib.crc32(p.encode()) % (vocab - 2000)) for p in pieces]
    toks = [t if t != eos else t + 1 for t in toks]
    return np.asarray(toks[:n], np.int32)


def _block_keys(q, k, s) -> None:
    """Keys at the block columns [s, s + K1), one per kv head along its
    queries' mean direction, scaled so that a block row's mean score with
    them is SPEC_BLOCK_SCORE: the block's own keys then carry much of its
    attention, as recent tokens do, and a row that sees one block key too
    many moves far."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    u = qg.sum((1, 3))
    u = u / u.norm(dim=-1, keepdim=True)
    unit_score = torch.einsum("bshgd,bhd->bshg", qg, u).mean() / D ** 0.5
    k[:, s:s + S] = (SPEC_BLOCK_SCORE / unit_score * u)[:, None].expand(B, S, Hkv, D).to(k.dtype)


def spec_kernel_cases(dev, cfg, gen, results) -> None:
    """K4 at S = K1 (the verify blocks of 18c and of every long-context
    speculative group), K3 at S = K1 (``decode_attn_impl="pallas"`` over a
    sampled arena of GSPO's geometry), each against its plain version with
    its bound and SDPA; a K4 whose block rows each see the key after their
    own must fail the bound."""
    t = cfg.text
    for B, T, dtype in SPEC_K4_CASES:
        s = T - 2 * SPEC_K1 - 100  # a block in the middle of a long row, columns past it unwritten
        w = s + SPEC_K1
        k, v = _layer_views(dev, gen, cfg, B, T, w, dtype)
        q = torch.randn((B, SPEC_K1, t.num_attention_heads, t.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        pos = (s + torch.arange(SPEC_K1, dtype=torch.int32, device=dev)).repeat(B, 1)
        valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
        valid[:, :w] = 1
        if B > 1:  # a sampled arena: holes where rejected drafts were
            holes = torch.rand((B, 4000), generator=gen, device=dev) < 0.3
            valid[:, s - 4000:s][holes] = 0
        else:
            _block_keys(q, k, s)
        kb, vb = k[:, :w].to(torch.bfloat16), v[:, :w].to(torch.bfloat16)
        mask = causal_mask(pos, valid[:, :w])
        ref = compare("decode_attention_gqa",
                      lambda: da.decode_attention_gqa(q, k, v, pos, valid),
                      lambda: da.decode_attention_gqa_torch(q, k[:, :w], v[:, :w], pos,
                                                            valid[:, :w]),
                      pos >= 0, results, case=f"S = {SPEC_K1}, B = {B}, T = {T}, {dtype}",
                      flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
                      moved=nbytes(q, k[:, :w], v[:, :w], pos, valid) + nbytes(q),
                      library_fn=lambda: sdpa_masked(q, kb, vb, mask))
        if B == 1:  # planted: each block row sees the key after its own
            out = da.decode_attention_gqa_torch(q, k[:, :w], v[:, :w], pos + 1, valid[:, :w])
            planted("decode_attention_gqa", "block row sees the next key", out, ref, pos >= 0)
        del k, v, kb, vb, mask, ref
    # K3 at S = K1 under decode_attn_impl="pallas": the sampled arena
    B = 4
    L = SPEC_GSPO_PROMPT
    T = L + 768 + 1024 + 2 * SPEC_K1
    s = L + SPEC_K3_CURSOR
    k, v = _layer_views(dev, gen, cfg, B, T, s + SPEC_K1, torch.bfloat16)
    q = torch.randn((B, SPEC_K1, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = (s + torch.arange(SPEC_K1, dtype=torch.int32, device=dev)).repeat(B, 1)
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    valid[:, :s + SPEC_K1] = 1
    valid[:, L:s][torch.rand((B, s - L), generator=gen, device=dev) < 0.5] = 0
    w = s + SPEC_K1
    mask = causal_mask(pos, valid[:, :w])
    compare("flash_attention_gqa",
            lambda: fa.flash_attention_gqa(q, k, v, pos, valid),
            lambda: fa.flash_attention_gqa_torch(q, k[:, :w], v[:, :w], pos, valid[:, :w]),
            pos >= 0, results, case=f"S = {SPEC_K1} verify, 4 x {T} (decode_attn_impl pallas)",
            flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(q, k[:, :w], v[:, :w], pos, valid) + nbytes(q),
            library_fn=lambda: sdpa_masked(q, k[:, :w], v[:, :w], mask))
    del k, v, mask
    torch.cuda.empty_cache()


def first_divergence(params, cfg, req, plain, spec) -> tuple:
    """The first index where the spec tokens differ from the plain path's
    (None: nowhere) and, there, the plain step's top-2 logit gap (the
    prefill logits of the prompt and the plain tokens before it)."""
    k = next((i for i, (a, b) in enumerate(zip(plain, spec)) if a != b), None)
    if k is None:
        return None, None
    forced = dataclasses.replace(req, input_ids=list(req.input_ids) + list(plain[:k]))
    if forced.pixel_patches is None:
        dev = params["text"]["embed_tokens"].device
        with torch.inference_mode():
            ids = torch.tensor([forced.input_ids], device=dev)
            hidden, _ = text_forward(params["text"], cfg.text, embed_tokens(params, ids),
                                     torch.arange(ids.shape[1], device=dev)[None, None].expand(
                                         3, 1, -1))
            logits = logits_from_hidden(params["text"], hidden[:, -1]).float()
    else:
        logits = _vision_and_logits(params, cfg, [forced], "auto")[1]
    top = logits[0].topk(2).values
    return k, float(top[0] - top[1])


def spec_pair(tag, params, cfg, req, sampling, engine_kw, plain_tokens=None) -> dict:
    """One request through a spec_decode engine, after a warm-up call, and
    (without ``plain_tokens``) through a plain one the same way: tokens,
    the first divergence and its top-2 gap (at most SPEC_TIE_GAP), verify
    steps, tokens per verify, decode ms/token of both (the decode stage,
    captures included, over the tokens decode emitted), captures."""
    runs = {}
    for name, spec in (("spec", True), ("plain", False)):
        if not spec and plain_tokens is not None:
            continue
        engine = InferenceEngine(params, cfg, spec_decode=spec, spec_draft=SPEC_DRAFT, **engine_kw)
        engine.generate([req], dataclasses.replace(sampling, max_tokens=2))
        stats0 = dict(engine.spec_stats)
        out, run = decode_run(engine, lambda: engine.generate([req], sampling)[0])
        run["tokens"] = out["token_ids"]
        run["decode_ms_per_token"] = round(1e3 * engine.stage_seconds["decode"]
                                           / max(len(out["token_ids"]) - 1, 1), 3)
        run["stats"] = {k: engine.spec_stats[k] - stats0[k] for k in stats0}
        runs[name] = run
        del engine
    plain = plain_tokens if plain_tokens is not None else runs["plain"]["tokens"]
    spec = runs["spec"]
    k, gap = first_divergence(params, cfg, req, plain, spec["tokens"])
    st = spec["stats"]
    log("spec", run=tag, prompt_tokens=len(req.input_ids), new_tokens=len(spec["tokens"]),
        identical_tokens=spec["tokens"] == plain, first_divergence=k, plain_top2_gap=gap,
        bound=SPEC_TIE_GAP, verify_steps=st["verify_steps"],
        tokens_per_verify=round(st["emitted"] / max(st["verify_steps"], 1), 3),
        spec_decode_ms_per_token=spec["decode_ms_per_token"],
        plain_decode_ms_per_token=runs["plain"]["decode_ms_per_token"] if "plain" in runs else None,
        spec_capture_ms=spec["capture_ms"],
        verify_captures=spec["scheduler"]["verify_captures"],
        captures=spec["scheduler"]["captures"], decode_kernel_launches=spec["launches"])
    graphed = params["text"]["embed_tokens"].device.type == "cuda"
    if st["verify_steps"] < 1 or (graphed and spec["scheduler"]["verify_captures"] < 1):
        raise RuntimeError(f"{tag}: no graphed verify step ran: {st}, {spec['scheduler']}")
    if k is not None and gap > SPEC_TIE_GAP:
        raise RuntimeError(f"{tag}: the spec tokens leave the plain path's at step {k}, where "
                           f"its top-2 logit gap {gap} exceeds {SPEC_TIE_GAP}")
    return spec


def spec_gspo(trainer, sample, step, tag) -> dict:
    """One GSPO step of the spec_rollout trainer (``gspo_step``): the
    rollout's seconds, spec_stats, compactions and peak GiB."""
    stats0 = dict(trainer.engine.spec_stats)
    comp0 = trainer.engine.counters["compactions"]
    got = gspo_step(trainer, sample, step, tag, GSPO_KERNELS)
    st = {k: trainer.engine.spec_stats[k] - stats0[k] for k in stats0}
    got["rollout_s"] = trainer.timer.report()["rollout"]["total_s"]
    got["stats"] = st
    got["compactions"] = trainer.engine.counters["compactions"] - comp0
    got["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    return got


def spec_phase(params, cfg, reqs, proc, long_tokens_a, seed, results) -> dict:
    """Phase 18: the verify blocks' kernel cases; 18a greedy speculation on
    the slice's first request against the plain path; 18b GSPO with
    spec_rollout under PEFT, worst (the probe reverts) and replay (the
    streams equal the trace), against a plain rollout; 18c greedy
    speculation at run (a)'s length (K4 at S = K1 in the engine). Returns
    18c's decode launches."""
    t_phase = time.perf_counter()
    dev = params["text"]["embed_tokens"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 18)
    spec_kernel_cases(dev, cfg, gen, results)

    # 18a
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=SPEC_TOKENS)
    spec_pair("18a", params, cfg, reqs[0], greedy, {})
    gc.collect()
    torch.cuda.empty_cache()

    # 18b
    for x in P.leaves(params):
        x.requires_grad_(False)
    sample = gspo_sample(proc, seed)
    gcfg = GSPOConfig(spec_rollout=True)
    trainer = GSPOTrainer(params, None, cfg, gcfg, detokenize=CannedTraces(proc),
                          lora=LoraConfig(seed=seed), seed=seed)
    worst = spec_gspo(trainer, sample, 0, "18b worst")
    req = Request(input_ids=list(sample["input_ids"]), pixel_patches=sample["pixel_patches"],
                  grid_thw=sample["grid_thw"], vision_token_id=sample.get("vision_token_id"))
    sampling = SamplingParams(temperature=gcfg.temperature, top_p=gcfg.top_p,
                              repetition_penalty=1.0, max_tokens=gcfg.max_completion_length,
                              seed=seed)
    plain_engine = InferenceEngine(trainer.policy_params(), cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_outs = plain_engine.generate([req] * gcfg.num_generations, sampling)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del plain_engine
    trainer.engine.spec_warmup, trainer.engine.spec_min_rate = 0, 0.0
    trace = np.stack([reasoning_trace_tokens(gcfg.max_completion_length + SPEC_TRACE_EXTRA, r,
                                             cfg.text.vocab_size, cfg.eos_token_id)
                      for r in range(gcfg.num_generations)])
    trainer.replay_tokens = trace
    replay = spec_gspo(trainer, sample, 1, "18b replay")
    n = gcfg.max_completion_length
    equal = [list(ids)[1:] == trace[r, 1:n].tolist() for r, ids in enumerate(replay["tokens"])]
    for tag, got in (("worst", worst), ("replay", replay)):
        st = got["stats"]
        log("spec", run=f"18b {tag}", rollout_s=got["rollout_s"], plain_rollout_s=round(plain_s, 4),
            rollout_vs_plain=round(got["rollout_s"] / plain_s, 3),
            completion_lengths=[len(t) for t in got["tokens"]], verify_steps=st["verify_steps"],
            tokens_per_verify=round(st["emitted"] / max(st["verify_steps"], 1), 3),
            probe_disabled=st["probe_disabled"], compactions=got["compactions"],
            peak_mem_gib=got["peak_gib"], loss=got["metrics"]["loss"])
    log("spec", run="18b replay", streams_equal_to_trace=equal,
        plain_completion_lengths=[len(o["token_ids"]) for o in plain_outs])
    if worst["stats"]["probe_disabled"] < 1:
        raise RuntimeError(f"18b worst: the probe did not revert random-init sampling: "
                           f"{worst['stats']}")
    if not all(equal) or replay["stats"]["verify_steps"] < 1:
        raise RuntimeError(f"18b replay: streams equal to the trace {equal}, {replay['stats']}")
    trainer.engine.release_memory()
    del trainer, plain_outs
    gc.collect()
    torch.cuda.empty_cache()

    # 18c
    long_kw = dict(cache_dtype=torch.bfloat16, long_prefill_chunk=LONG_CHUNK)
    long_spec = spec_pair("18c", params, cfg, long_request(LONG_RUNS[0][1]),
                          long_sampling(seed), long_kw, plain_tokens=long_tokens_a)
    if dev.type == "cuda" and not long_spec["launches"].get("decode_attention_gqa"):
        raise RuntimeError(f"18c: K4 did not launch in the verify blocks: {long_spec['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    log("spec", phase_seconds=round(time.perf_counter() - t_phase, 3))
    return long_spec["launches"]


# Phase 19: the uint8 frame path and w8a8 serving. 19a serves the slice's
# requests as host patches, as Request.frames and through prestage_frames on
# a prefetch thread, then a 640x360 AVI (phase 16's, from the same seed)
# read by fetch_video_raw and resized on the card; 19b the quality leg of
# the JAX bench (bf16, w8, w8a8 on the first request's frames, 64 greedy
# tokens, penalty 1.0); 19c run (b)'s prompt with int8 text weights, with
# and without a8_prefill (the JAX bench's 81920:fp8:a8).
FRAMES_DIR = "checkpoints/chip_smoke_frames"  # in the checkout (gitignored), removed after
FRAMES_AVI_PIXELS = 360 * 420  # the eval wrapper's video_max_pixels
A8_TOKENS = 64
A8_LONG_TOKENS = 8
A8_MODES = {  # mode -> (quantized leaves, a8_prefill)
    "bf16": ((), False),
    "w8": (quant.DEFAULT_QUANT_PATTERNS, False),
    "w8a8": (quant.DEFAULT_QUANT_PATTERNS + quant.VISION_QUANT_PATTERNS, True),
}


def _served(engine, reqs, sampling) -> tuple[list[dict], dict]:
    """One generate call: its outputs, and its stage ms, the bytes its
    admissions uploaded, its tower passes and K1-K3 launches."""
    stages, counts = collections.Counter(engine.stage_seconds), collections.Counter(
        engine.counters)
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = engine.generate(reqs, sampling)
    stages = collections.Counter(engine.stage_seconds) - stages
    counts = collections.Counter(engine.counters) - counts
    return outs, {"vis_upload_ms": round(1e3 * stages["vis_upload"], 3),
                  "vision_ms": round(1e3 * stages["vision"], 3),
                  "prefill_ms": round(1e3 * stages["prefill"], 3),
                  "upload_bytes": counts["upload_bytes"], "tower_passes": counts["tower_passes"],
                  "launches": {name: kernels.LAUNCHES[name] for name in SLICE_KERNELS}}


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def frames_slice_check(engine, proc, cfg, seed: int, sampling) -> None:
    """19a.1: the slice's two requests three ways, one call each: host
    patches; Request.frames; prestage_frames on a prefetch thread (while
    the frames call runs, so its uploads meet that call's decode capture
    under the engine's lock). The tower input of each way against the host
    path's (must be 0) and the greedy tokens (must be equal)."""
    dev = engine.device
    reqs, frames = make_requests(proc, cfg, seed), slice_frames(seed)
    ref_rows = [torch.from_numpy(r.pixel_patches).to(dev).to(cfg.dtype) for r in reqs]
    engine.generate(reqs, dataclasses.replace(sampling, max_tokens=2))  # warm-up
    host, host_run = _served(engine, reqs, sampling)
    staged = {}

    def prefetch():
        t0 = time.perf_counter()
        staged["rows"] = engine.prestage_frames(frames)
        torch.cuda.synchronize()
        staged["ms"] = round(1e3 * (time.perf_counter() - t0), 3)

    framed = [dataclasses.replace(r, pixel_patches=None, frames=f) for r, f in zip(reqs, frames)]
    thread = threading.Thread(target=prefetch)
    thread.start()
    framed_outs, framed_run = _served(engine, framed, sampling)
    thread.join()
    if "rows" not in staged:
        raise RuntimeError("19a: prestage_frames failed on the prefetch thread")
    prestaged = [dataclasses.replace(r, pixel_patches=p) for r, p in zip(reqs, staged["rows"])]
    pre_outs, pre_run = _served(engine, prestaged, sampling)
    with torch.inference_mode():
        engine_rows = [engine._frames_to_patches([f], None)[0][0] for f in frames]
    ways = {"pixel_patches": (ref_rows, host, host_run),
            "frames": (engine_rows, framed_outs, framed_run),
            "prestage_frames": (staged["rows"], pre_outs, {**pre_run,
                                                           "prestage_ms": staged["ms"]})}
    for way, (rows, outs, run) in ways.items():
        diff = max(_max_diff(a, b) for a, b in zip(rows, ref_rows))
        same = [o["token_ids"] for o in outs] == [o["token_ids"] for o in host]
        log("frames", way=way, tower_input_max_abs_diff=diff, identical_tokens=same, **run)
        if diff != 0.0 or not same:
            raise RuntimeError(f"19a {way}: tower input differs by {diff} or the tokens differ")
    log("frames", first_token_ids=[o["token_ids"][:8] for o in host],
        patch_bytes=sum(r.pixel_patches.nbytes for r in reqs),
        frame_bytes=sum(f.nbytes for f in frames))


def frames_avi_check(params, engine, proc, cfg, seed: int, sampling) -> None:
    """19a.2: phase 16's 640x360 AVI (from the same seed) through
    fetch_video_raw; the device resize to its smart_resize target against
    the host resize of fetch_video (torch on the CPU), with TF32 off and on
    around it (count, share and largest difference of the pixels, at most 1
    LSB; TF32 must change nothing); then the frames + resize_hw request
    against the host-resized pixel_patches request, greedy: equal tokens
    where no pixel differs, else the first difference and the plain step's
    top-2 gap there."""
    dev = engine.device
    os.makedirs(FRAMES_DIR, exist_ok=True)
    avi = f"{FRAMES_DIR}/clip.avi"
    n = int(EVAL_SECONDS * EVAL_FPS)
    write_raw_avi(avi, np.random.default_rng(seed + 16).integers(
        0, 256, size=(n, EVAL_H, EVAL_W, 3), dtype=np.uint8), EVAL_FPS)
    t0 = time.perf_counter()
    raw, (h, w), fps = TV.fetch_video_raw({"video": avi, "nframes": N_FRAMES,
                                           "max_pixels": FRAMES_AVI_PIXELS})
    read_ms = round(1e3 * (time.perf_counter() - t0), 3)
    host = TV.resize_frames(torch.from_numpy(raw), h, w)
    wh, ww = engine._resize_weights(tuple(raw.shape[2:]), (h, w))
    x = torch.from_numpy(raw).to(dev)
    outs = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            outs[tf32] = resize_frames_device(x, wh, ww).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        d = (outs[tf32] - host).abs()
        n_diff = int((d > 0).sum())
        log("frames", resize=f"{raw.shape[2]}x{raw.shape[3]} -> {h}x{w}", frames=raw.shape[0],
            tf32=tf32, reader=TV.get_video_reader_backend(), read_ms=read_ms, fps=fps,
            pixels_differ=n_diff, share=n_diff / d.numel(), max_diff=d.max().item())
        if d.max().item() > 1.0:
            raise RuntimeError(f"19a: the device resize is {d.max().item()} LSB off the host's")
    if not torch.equal(outs[True], outs[False]):
        raise RuntimeError("19a: TF32 switched on around the device resize changed it")
    question = QUESTIONS[0]
    plain = frames_request(proc, cfg, host.numpy(), question)
    framed = dataclasses.replace(plain, pixel_patches=None, frames=raw, resize_hw=(h, w))
    plain_outs, plain_run = _served(engine, [plain], sampling)
    framed_outs, framed_run = _served(engine, [framed], sampling)
    a, b = plain_outs[0]["token_ids"], framed_outs[0]["token_ids"]
    k, gap = first_divergence(params, cfg, plain, a, b)
    log("frames", way="pixel_patches (host resize)", prompt_tokens=len(plain.input_ids),
        **plain_run)
    log("frames", way="frames + resize_hw", identical_tokens=a == b, first_divergence=k,
        plain_top2_gap=gap, **framed_run)
    if a != b and int((outs[False] - host).abs().gt(0).sum()) == 0:
        raise RuntimeError("19a: equal tower inputs, other tokens")


def frames_phase(params, cfg, proc, seed: int) -> None:
    """Phase 19a (``frames_slice_check``, ``frames_avi_check``), greedy,
    repetition penalty 1.05, MAX_TOKENS new tokens."""
    t_phase = time.perf_counter()
    sampling = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=MAX_TOKENS)
    engine = InferenceEngine(params, cfg)
    try:
        frames_slice_check(engine, proc, cfg, seed, sampling)
        frames_avi_check(params, engine, proc, cfg, seed, sampling)
    finally:
        shutil.rmtree(FRAMES_DIR, ignore_errors=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log("frames", phase_seconds=round(time.perf_counter() - t_phase, 3))


@contextlib.contextmanager
def int_mm_calls(out: dict):
    """The w8a8 products (``quant.A8_MATMULS["int_mm"]``) made inside each
    call of the engine's tower (``tower``), prefill forwards (``prefill``)
    and lm_heads (``lm_head``) outside decode segments, and in all inside
    them (``decode``), appended to ``out``'s lists."""
    names = {"tower": "encode_vision", "prefill": "text_forward", "lm_head": "logits_from_hidden"}
    real = {key: getattr(engine_module, name) for key, name in names.items()}
    real_segment = engine_module._GroupRun.segment
    state = {"decode": False}

    def counted(key):
        def call(*args, **kw):
            before = quant.A8_MATMULS["int_mm"]
            got = real[key](*args, **kw)
            out.setdefault("decode" if state["decode"] else key, []).append(
                quant.A8_MATMULS["int_mm"] - before)
            return got
        return call

    def segment(run, *args, **kw):
        state["decode"] = True
        try:
            return real_segment(run, *args, **kw)
        finally:
            state["decode"] = False

    for key, name in names.items():
        setattr(engine_module, name, counted(key))
    engine_module._GroupRun.segment = segment
    try:
        yield out
    finally:
        for key, name in names.items():
            setattr(engine_module, name, real[key])
        engine_module._GroupRun.segment = real_segment


def teacher_forced(params, cfg, req, tokens, a8: bool) -> list[int]:
    """The JAX bench's teacher-forced argmax: one forward over the prompt and
    ``tokens`` (under a8_acts when ``a8``), the argmax at each completion
    position."""
    dev = params["text"]["embed_tokens"].device
    ids = np.asarray([list(req.input_ids) + list(tokens)])
    pos, _ = get_rope_index(cfg, ids, image_grid_thw=req.grid_thw)
    n = len(req.input_ids)
    with torch.inference_mode(), quant.a8_acts(a8):
        hidden, _ = model_forward(params, cfg, torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(pos).to(dev),
                                  pixel_patches=torch.from_numpy(req.pixel_patches).to(dev),
                                  grid_thw=req.grid_thw, vision_token_id=cfg.image_token_id,
                                  return_hidden=True)
        logits = logits_from_hidden(params["text"], hidden[:, n - 1:-1])
    return logits.argmax(-1)[0].tolist()


def quant_phase(params, cfg, proc, seed: int) -> None:
    """19b: the JAX bench's quality leg on the card: the first request's
    frames (Request.frames), the same random weights as bf16, w8
    (quantize_text) and w8a8 (quantize_text + quantize_vision +
    a8_prefill), A8_TOKENS greedy tokens at repetition penalty 1.0; per
    mode the teacher-forced and free-run agreement with bf16, vision,
    prefill and decode ms, weight and peak GiB, and the w8a8 products
    (torch._int_mm) per tower pass, prefill forward, lm_head and decode
    step. Each mode's weights are freed before the next."""
    req = make_requests(proc, cfg, seed)[0]
    framed = dataclasses.replace(req, pixel_patches=None, frames=slice_frames(seed)[0])
    sampling = SamplingParams(temperature=0.0, repetition_penalty=1.0, max_tokens=A8_TOKENS)
    streams, forced = {}, {}
    v, t = cfg.vision, cfg.text
    for mode, (patterns, a8) in A8_MODES.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mparams = quant.quantize_params(params, patterns) if patterns else params
        engine = InferenceEngine(mparams, cfg, a8_prefill=a8)
        engine.generate([framed], dataclasses.replace(sampling, max_tokens=2))  # warm-up
        calls: dict = {}
        with int_mm_calls(calls):
            out, run = decode_run(engine, lambda: engine.generate([framed], sampling)[0])
        streams[mode] = out["token_ids"]
        forced[mode] = teacher_forced(mparams, cfg, req, streams["bf16"], a8)
        want = ({"tower": [5 * v.depth], "prefill": [7 * t.num_hidden_layers], "lm_head": [1]}
                if a8 else {"tower": [0], "prefill": [0], "lm_head": [0]})
        got = {k: calls.get(k, []) for k in want}
        decode_int_mm = sum(calls.get("decode", []))
        m = min(len(streams["bf16"]), len(out["token_ids"]))
        free = [x == y for x, y in zip(streams["bf16"][:m], out["token_ids"][:m])]
        log("quant", mode=mode, new_tokens=len(out["token_ids"]),
            teacher_forced_agreement=round(float(np.mean(
                [x == y for x, y in zip(forced["bf16"], forced[mode])])), 4),
            freerun_agreement=round(float(np.mean(free)), 4) if m else 0.0,
            freerun_first_divergence=free.index(False) if False in free else None,
            vision_ms=round(1e3 * run["vision_s"], 3), prefill_ms=round(1e3 * run["prefill_s"], 3),
            decode_ms_per_token=run["ms_per_token"],
            weight_gib=round(quant.param_bytes(mparams) / 2**30, 3),
            peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
            int_mm_calls={**got, "decode": decode_int_mm}, launches=run["launches"])
        if got != want or decode_int_mm:
            raise RuntimeError(f"19b {mode}: w8a8 products {got}, decode {decode_int_mm}; "
                               f"expected {want} and none in decode")
        if not 1 <= len(out["token_ids"]) <= A8_TOKENS:
            raise RuntimeError(f"19b {mode}: bad output length {len(out['token_ids'])}")
        del engine, mparams
    gc.collect()
    torch.cuda.empty_cache()


def quant_long_phase(params, cfg, seed: int) -> None:
    """19c: run (b)'s prompt (81888 tokens, fp8 cache, 8192-token chunks)
    with int8 text weights, without and with a8_prefill: prefill s, the
    first A8_LONG_TOKENS tokens of each, the w8a8 products per prefill
    chunk."""
    qparams = quant.quantize_params(params, quant.DEFAULT_QUANT_PATTERNS)
    sampling = dataclasses.replace(long_sampling(seed), max_tokens=A8_LONG_TOKENS)
    n = LONG_RUNS[1][1]
    tokens = {}
    for a8 in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = InferenceEngine(qparams, cfg, cache_dtype=torch.float8_e4m3fn,
                                 long_prefill_chunk=LONG_CHUNK, a8_prefill=a8)
        calls: dict = {}
        with int_mm_calls(calls):
            out, run = decode_run(engine, lambda: engine.generate([long_request(n)], sampling)[0])
        tokens[a8] = out["token_ids"]
        log("quant", run="81920:fp8" + (":a8" if a8 else ""), prompt_tokens=n,
            prefill_s=run["prefill_s"], prefill_tok_per_s=round(n / run["prefill_s"], 1),
            prefills=run["scheduler"]["prefills"], first_token_ids=out["token_ids"][:8],
            int_mm_per_prefill=sorted(set(calls.get("prefill", []))),
            decode_ms_per_token=run["ms_per_token"],
            peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
        if a8 and set(calls.get("prefill", [])) != {7 * cfg.text.num_hidden_layers}:
            raise RuntimeError(f"19c: w8a8 products per prefill chunk {calls.get('prefill')}")
        if not 1 <= len(out["token_ids"]) <= A8_LONG_TOKENS:
            raise RuntimeError(f"19c: bad output length {len(out['token_ids'])}")
        del engine
    log("quant", run="19c", identical_first_tokens=tokens[False] == tokens[True])
    del qparams
    gc.collect()
    torch.cuda.empty_cache()


def serving_modes_phase(params, cfg, proc, seed: int) -> None:
    """Phase 19: 19a the frame path, 19b the quantized modes, 19c w8a8 at
    run (b)'s length."""
    t_phase = time.perf_counter()
    frames_phase(params, cfg, proc, seed)
    t0 = time.perf_counter()
    quant_phase(params, cfg, proc, seed)
    t1 = time.perf_counter()
    quant_long_phase(params, cfg, seed)
    log("quant", phase_seconds={"19b": round(t1 - t0, 3),
                                "19c": round(time.perf_counter() - t1, 3),
                                "19": round(time.perf_counter() - t_phase, 3)})


# Phase 20: Qwen3-VL-8B and Qwen2-VL-7B from their published configs.
# Qwen3-VL: 16 frames of 256x352 per question (16x22 patches of 16: K2 at
# W = 352, resident), and one video of 8 frames resized on the card to
# 448x448 (28x28 patches: W = 784, streamed), each frame a block
# <t seconds><|vision_start|><|video_pad|> x 196<|vision_end|>.
Q3_FRAME_H, Q3_FRAME_W = 256, 352
Q3_VIDEO_FRAMES, Q3_VIDEO_HW, Q3_VIDEO_RAW_HW = 8, (448, 448), (360, 640)
Q3_QUESTION = "What happens to the bowling ball?"
# K2's phase-20 cases, 16 heads: (row, frames, W, head_dim): at Qwen3-VL's
# 72 (1152 / 16) over its image frames and its video's, and at Qwen2-VL's
# 80 over phase 4's frames of 18x24 patches (its 432 tokens, all valid).
K2_FAMILY_CASES = (("window_attention_d72_w352", N_FRAMES, 352, 72),
                   ("window_attention_d72_w784", Q3_VIDEO_FRAMES, 784, 72),
                   ("window_attention_qwen2vl", N_FRAMES, 432, 80))
# Zeroing the deepstack taps must move the last-position logits by at least
# this share of their norm (a tap that never reached the decoder moves them
# by 0).
DEEPSTACK_MIN_REL = 1e-3
FAMILY_KERNELS = ("window_attention", "flash_attention_gqa")


def k2_family_cases(dev, gen, results) -> None:
    """20a: K2 against its plain version at whole frames of the two
    families (K2_FAMILY_CASES): at head_dim 72, W = 352 (resident) and 784
    (streamed); at 80, W = 432. Then the planted fault at 72: the neighbour
    head's columns. K2's tile at 72 holds the head's own 72 columns, so the
    even heads' outputs must stay bit-equal when the odd heads' q, k, v are
    scaled by 64; and what a kernel reading 8 columns of the next head into
    its scores (a fifth 16-wide step) would give must fail the bound."""
    heads = 16
    for name, n, w, d in K2_FAMILY_CASES:
        ids = torch.ones((n, w), dtype=torch.int32, device=dev)
        q, k, v = (torch.randn((n, w, heads, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        seg = segment_mask(ids)
        ref = compare(name, lambda: wa.window_attention(q, k, v, ids),
                      lambda: wa.window_attention_torch(q, k, v, ids), None, results,
                      flops=4 * segment_pairs(ids) * heads * d, moved=nbytes(q, k, v, ids, q),
                      library_fn=lambda: sdpa_masked(q, k, v, seg), case=f"head_dim {d}, W = {w}")
        if name != K2_FAMILY_CASES[0][0]:
            continue
        out = wa.window_attention(q, k, v, ids)
        loud = [x.clone() for x in (q, k, v)]
        for x in loud:
            x[:, :, 1::2] *= 64
        out_loud = wa.window_attention(*loud, ids)
        torch.cuda.synchronize()
        same = torch.equal(out[:, :, 0::2], out_loud[:, :, 0::2])
        log("kernels", name=name, check="odd heads x64, even heads' outputs bit-equal",
            equal=same)
        if not same:
            raise RuntimeError(f"{name}: a head's output depends on its neighbour's columns")
        # the leak: scores over 80 columns, the next head's first 8 included
        # (the last head's neighbour is the zero fill past the row)
        nxt = [torch.cat([x[:, :, 1:, :8], torch.zeros_like(x[:, :, :1, :8])], 2)
               for x in loud]
        q80, k80, v80 = (torch.cat([x, y], -1) for x, y in zip(loud, nxt))
        leak = wa.window_attention_torch(q80 * (80 / 72) ** 0.5, k80, v80, ids)[..., :d]
        planted(name, "scores over 8 columns of the next head",
                leak, wa.window_attention_torch(*loud, ids), None)
        del out, out_loud, loud, nxt, q80, k80, v80, leak
    del q, k, v, seg, ref


def k3_prefill_case(dev, gen, t, batch_rows, t_total, name, results, case=None) -> None:
    """K3 at a prefill (the 7B slice's in phase 3, Qwen3-VL-8B's in phase
    20): ``batch_rows`` prompts left-padded into one batch (as the engine
    lays rows out) against layer views of a stacked cache of ``t_total``
    slots, the text config ``t``'s heads."""
    B, S = len(batch_rows), max(batch_rows)
    q = torch.randn((B, S, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    cache = torch.zeros((2, 4, B, t_total, t.num_key_value_heads, t.head_dim),
                        dtype=torch.bfloat16, device=dev)
    k, vv = cache[0, 3], cache[1, 3]  # layer views of the stacked cache
    k.copy_(torch.randn(k.shape, generator=gen, device=dev).to(torch.bfloat16))
    vv.copy_(torch.randn(vv.shape, generator=gen, device=dev).to(torch.bfloat16))
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    valid = torch.zeros((B, t_total), dtype=torch.int32, device=dev)
    for b, n in enumerate(batch_rows):
        valid[b, S - n:S] = 1
    mask = causal_mask(pos, valid)
    compare(name, lambda: fa.flash_attention_gqa(q, k, vv, pos, valid),
            lambda: fa.flash_attention_gqa_torch(q, k, vv, pos, valid),
            valid[:, :S] != 0, results,
            flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(q, k, vv, pos, valid) + nbytes(q),
            library_fn=lambda: sdpa_masked(q, k, vv, mask), case=case)


def qwen3_requests(proc, cfg, seed: int) -> list[Request]:
    """The slice's 2 questions for Qwen3-VL, each over 16 synthetic uint8
    frames of Q3_FRAME_H x Q3_FRAME_W as images (the processor at patch 16)."""
    rng = np.random.default_rng(seed)
    return [frames_request(proc, cfg, rng.integers(0, 256, size=(N_FRAMES, 3, Q3_FRAME_H,
                                                                 Q3_FRAME_W), dtype=np.uint8), q)
            for q in QUESTIONS]


def qwen3_video_request(proc, cfg, seed: int) -> Request:
    """A video of Q3_VIDEO_FRAMES uint8 frames resized on the card to
    Q3_VIDEO_HW (Request.frames, grid (8, 28, 28)), its prompt laid out as
    HF's Qwen3-VL processor lays one out: a timestamp and a vision block
    per frame."""
    rng = np.random.default_rng(seed + 1)
    frames = rng.integers(0, 256, size=(Q3_VIDEO_FRAMES, 3, *Q3_VIDEO_RAW_HW), dtype=np.uint8)
    gh, gw = (x // cfg.vision.patch_size for x in Q3_VIDEO_HW)
    per_frame = gh * gw // cfg.vision.merge_unit
    blocks = "".join(f"<{j / FPS:.1f} seconds><|vision_start|>{'<|video_pad|>' * per_frame}"
                     "<|vision_end|>" for j in range(Q3_VIDEO_FRAMES))
    prompt = proc.apply_chat_template([
        {"role": "system", "content": [{"type": "text", "text": SYSTEM_PROMPT}]},
        {"role": "user", "content": [{"type": "text", "text": blocks},
                                     {"type": "text", "text": Q3_QUESTION}]},
    ], add_generation_prompt=True)
    return Request(input_ids=proc(prompt).input_ids, frames=frames, resize_hw=Q3_VIDEO_HW,
                   grid_thw=np.array([[Q3_VIDEO_FRAMES, gh, gw]]),
                   vision_token_id=cfg.video_token_id)


def family_launches(tag, cfg, run, per_pass, passes, phase="families") -> dict:
    """The launch counts of one phase-20 (or 22) run, held to what the path
    makes: K2 in every tower block of every tower pass (K1 never: no
    windows), K3 in every decoder layer of every prefill forward, the
    RMSNorm kernel at every norm site of every forward (``norm_launches``)."""
    got = {name: kernels.LAUNCHES[name] for name in FAMILY_KERNELS + ("fused_window_attention",)}
    want = {"window_attention": per_pass * passes, "fused_window_attention": 0,
            "flash_attention_gqa": cfg.text.num_hidden_layers * run["scheduler"]["prefills"]}
    log(phase, run=tag, launches=got, expected=want, tower_passes=passes,
        prefills=run["scheduler"]["prefills"], decode_steps=run["steps"],
        graph_captures=run["scheduler"]["captures"])
    if got != want:
        raise RuntimeError(f"{tag}: launches {got}, expected {want}")
    return {**got, "rms_norm": norm_launches(tag, cfg, run, phase)}


def forced_agreement(params, cfg, req, tokens) -> float:
    """Teacher-forced agreement of the kernel path (impl "auto") with the
    plain bf16 path (impl "torch"): one forward over the prompt and
    ``tokens`` each way, the share of completion positions whose argmax is
    the same."""
    dev = params["text"]["embed_tokens"].device
    ids = np.asarray([list(req.input_ids) + list(tokens)])
    pos, _ = get_rope_index(cfg, ids, image_grid_thw=req.grid_thw)
    n = len(req.input_ids)
    argmax = []
    for impl in ("auto", "torch"):
        with torch.inference_mode():
            hidden, _ = model_forward(params, cfg, torch.from_numpy(ids).to(dev),
                                      torch.from_numpy(pos).to(dev),
                                      pixel_patches=torch.from_numpy(req.pixel_patches).to(dev),
                                      grid_thw=req.grid_thw, vision_token_id=cfg.image_token_id,
                                      attn_impl=impl, return_hidden=True)
            argmax.append(logits_from_hidden(params["text"], hidden[:, n - 1:-1], impl)
                          .argmax(-1)[0])
    return (argmax[0] == argmax[1]).float().mean().item()


def deepstack_check(params, cfg, req) -> float:
    """The last-position logits of ``req`` with its deepstack taps and with
    them zeroed (every deepstack merger's weights 0, so each tap is 0):
    their relative difference, which must be at least DEEPSTACK_MIN_REL."""
    dev = params["text"]["embed_tokens"].device
    ids = np.asarray([req.input_ids])
    pos, _ = get_rope_index(cfg, ids, image_grid_thw=req.grid_thw)
    zeroed = dict(params, visual=dict(params["visual"], deepstack=[
        {k: torch.zeros_like(x) for k, x in m.items()} for m in params["visual"]["deepstack"]]))
    logits = []
    for p in (params, zeroed):
        with torch.inference_mode():
            out, _ = model_forward(p, cfg, torch.from_numpy(ids).to(dev),
                                   torch.from_numpy(pos).to(dev),
                                   pixel_patches=torch.from_numpy(req.pixel_patches).to(dev),
                                   grid_thw=req.grid_thw, vision_token_id=cfg.image_token_id,
                                   return_hidden=True)
            logits.append(logits_from_hidden(p["text"], out[:, -1]).float())
    rel = ((logits[0] - logits[1]).norm() / logits[0].norm()).item()
    if not (torch.isfinite(logits[0]).all() and rel >= DEEPSTACK_MIN_REL):
        raise RuntimeError(f"20b: zeroing the deepstack taps moved the logits by {rel}")
    return rel


def tower_numerics(params, cfg, req) -> None:
    """The tower's embeddings and taps of the kernel path and of the plain
    bf16 path, each against the same weights' tower in float32 (plain): the
    kernel path at most SLICE_REL_RATIO further from it."""
    dev = params["text"]["embed_tokens"].device
    pix = torch.from_numpy(req.pixel_patches).to(dev)
    with torch.inference_mode():
        got = {impl: encode_vision(params, cfg, pix, req.grid_thw, impl=impl)
               for impl in ("auto", "torch")}
        ref = encode_vision({"visual": _cast(params["visual"], torch.float32)},
                            dataclasses.replace(cfg, dtype=torch.float32), pix.float(),
                            req.grid_thw, impl="torch")
    flat = {k: [v[0], *v[1]] if isinstance(v, tuple) else [v] for k, v in
            {**got, "f32": ref}.items()}
    for i, r in enumerate(flat["f32"]):
        rel_k, cos_k = _agreement(flat["auto"][i].float(), r)
        rel_p, _ = _agreement(flat["torch"][i].float(), r)
        log("families", numerics="tower" if i == 0 else f"deepstack tap {i - 1}",
            kernel_vs_f32_rel=rel_k, kernel_vs_f32_cos=cos_k, plain_vs_f32_rel=rel_p,
            max_ratio=SLICE_REL_RATIO)
        if not rel_k <= SLICE_REL_RATIO * rel_p:
            raise RuntimeError(f"20: the tower's kernel path is further from float32 than its "
                               f"plain bf16 path ({rel_k} vs {rel_p})")


def family_phase(dev, tag, cfg, reqs, seed: int) -> tuple[dict, dict, dict]:
    """One family at full width from random weights drawn from ``seed``:
    its requests greedy (MAX_TOKENS tokens) through InferenceEngine.generate
    graphed and then eagerly (tokens equal), launch counts, tower numerics;
    returns (params, the graphed run's numbers, its launches)."""
    t0 = time.perf_counter()
    params = P.init(cfg, seed, dev)
    torch.cuda.synchronize()
    log("families", model=tag, params=P.count(params),
        weight_gib=round(quant.param_bytes(params) / 2**30, 3),
        init_s=round(time.perf_counter() - t0, 3))
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=MAX_TOKENS)
    engine = InferenceEngine(params, cfg)
    outs, _, decode = slice_phase(engine, reqs, greedy, names=FAMILY_KERNELS)
    launches = family_launches(tag, cfg, decode, cfg.vision.depth, len(reqs))
    eager_pair(f"{tag} slice", params, cfg, reqs, greedy, outs, decode)
    tower_numerics(params, cfg, reqs[0])
    agree = forced_agreement(params, cfg, reqs[0], outs[0]["token_ids"])
    log("families", model=tag, teacher_forced_kernel_vs_plain=round(agree, 4),
        first_token_ids=[o["token_ids"][:8] for o in outs])
    return params, decode, launches


def families_phase(dev, seed: int, results: dict) -> dict:
    """Phase 20: 20a K2 at head_dim 72 and K3 at Qwen3-VL's prefill; 20b
    Qwen3-VL-8B (the deepstack check, then one video request through
    Request.frames: K2 streamed, the per-frame rope split); 20c
    Qwen2-VL-7B on phase 4's requests. Each model is freed before the next
    is drawn. Returns the launches of each new kernel row's main path."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg3 = Qwen25VLConfig.from_hf_dict(QWEN3_VL_8B_INSTRUCT_CONFIG)
    proc3 = O3VideoProcessor(patch_size=cfg3.vision.patch_size)
    reqs3 = qwen3_requests(proc3, cfg3, seed)
    rows = [len(r.input_ids) for r in reqs3]
    k2_family_cases(dev, gen, results)
    k3_prefill_case(dev, gen, cfg3.text, rows, max(rows) + MAX_TOKENS, "flash_attention_gqa_qwen3",
                    results, case=f"Qwen3-VL-8B prefill, {len(rows)} x {max(rows)}, 32/8 heads")
    t_a = time.perf_counter()

    params, _, launches3 = family_phase(dev, "Qwen3-VL-8B", cfg3, reqs3, seed)
    rel = deepstack_check(params, cfg3, reqs3[0])
    log("families", model="Qwen3-VL-8B", deepstack_zeroed_logits_rel=rel,
        min_rel=DEEPSTACK_MIN_REL)
    video = qwen3_video_request(proc3, cfg3, seed)
    engine = InferenceEngine(params, cfg3)
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=MAX_TOKENS)
    torch.cuda.reset_peak_memory_stats()
    out, vrun = decode_run(engine, lambda: engine.generate([video], greedy)[0])
    vlaunch = family_launches("Qwen3-VL-8B video", cfg3, vrun, cfg3.vision.depth, 1)
    log("families", run="Qwen3-VL-8B video", prompt_tokens=out["num_prompt_tokens"],
        grid=video.grid_thw.tolist(), new_tokens=len(out["token_ids"]),
        vision_ms=round(1e3 * vrun["vision_s"], 3), prefill_ms=round(1e3 * vrun["prefill_s"], 3),
        decode_ms_per_token=vrun["ms_per_token"],
        peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    if not 1 <= len(out["token_ids"]) <= MAX_TOKENS:
        raise RuntimeError(f"20b video: bad output length {len(out['token_ids'])}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()

    cfg2 = Qwen25VLConfig.from_hf_dict(QWEN2_VL_7B_INSTRUCT_CONFIG)
    params, _, launches2 = family_phase(dev, "Qwen2-VL-7B", cfg2,
                                        make_requests(O3VideoProcessor(), cfg2, seed), seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("families", phase_seconds={"20a": round(t_a - t_phase, 3), "20b": round(t_b - t_a, 3),
                                   "20c": round(time.perf_counter() - t_b, 3),
                                   "20": round(time.perf_counter() - t_phase, 3)})
    return {"window_attention_d72_w352": launches3["window_attention"],
            "window_attention_d72_w784": vlaunch["window_attention"],
            "flash_attention_gqa_qwen3": launches3["flash_attention_gqa"],
            "window_attention_qwen2vl": launches2["window_attention"]}


# Phase 21: training Qwen3-VL-8B and Qwen2-VL-7B. K2's exact mode and K6's
# whole-frame dq and dk/dv, 16 heads: (row suffix, frames, W, head_dim,
# padded rows at the end of frame 0): at Qwen3-VL's 72 over its image
# frames (16x22 patches, resident) and its video's (28x28, streamed), and
# at Qwen2-VL's 80 over phase 4's frames of 18x24 patches. Frame 0 ends in
# 32 pad rows, as a smaller frame padded to its row's width in a mixed
# grid, so the segment mask has something to hide. The first case of each
# suffix gives its rows.
K6_FAMILY_CASES = (("_d72", N_FRAMES, 352, 72, 32), ("_d72", Q3_VIDEO_FRAMES, 784, 72, 32),
                   ("_qwen2vl", N_FRAMES, 432, 80, 32))
TRAIN_FAMILY_ROWS = ("window_attention_exact", "window_attention_bwd_dq",
                     "window_attention_bwd_dkv")
# 21b: the full fine-tune steps of Qwen3-VL-8B at full width and depth on
# phase 9's example over 16 frames of 256x352 (as images, patch 16); then
# the numerics at 9 ViT blocks (the tap after block 8 kept) and 2 decoder
# layers. 21c: PEFT steps. 21d: the full-FT GSPO step at 9 blocks and 4
# layers. 21e: one full fine-tune step of Qwen2-VL-7B on phase 9's batch.
Q3_SFT_STEPS, Q3_PEFT_STEPS, Q2_SFT_STEPS = 3, 2, 1
Q3_CUT_VIT, Q3_CUT_TEXT, Q3_FT_TEXT = 9, 2, 4
# What each path launches: every whole-frame block's K2 (exact under
# autograd) and K6, the decoder's K3 exact and K5; no window row kernel.
WINDOW_ROW_KERNELS = ("fused_window_attention", "fused_window_attention_exact",
                      "fused_window_attention_bwd")
DECODER_TRAIN_KERNELS = ("flash_attention_gqa_exact", "flash_attention_gqa_bwd_dq",
                         "flash_attention_gqa_bwd_dkv")
FAMILY_FT_KERNELS = TRAIN_FAMILY_ROWS + DECODER_TRAIN_KERNELS
FAMILY_PEFT_KERNELS = ("window_attention",) + DECODER_TRAIN_KERNELS
FAMILY_GSPO_KERNELS = ("window_attention", "flash_attention_gqa") + DECODER_TRAIN_KERNELS


def window_dq_delta0(q, k, v, ids, dout):
    """dq of the plain window backward with delta = rowsum(dp * p) taken
    as 0 (a planted fault): scale * (p * dp) @ k."""
    qt, kt, vt, dot = (x.transpose(1, 2).float() for x in (q, k, v, dout))
    p, _, _ = wa._exact_probs(qt, kt, wa._segment_mask(ids))
    dq = (p * (dot @ vt.transpose(-1, -2))) @ kt * q.shape[-1] ** -0.5
    return dq.transpose(1, 2).to(q.dtype)


def neighbour_leak_dq(q, k, v, ids, dout):
    """dq of a kernel whose products over D read 8 columns of the next head
    (a 16-wide step past D = 72; the last head's neighbour is the zero fill
    past the row), the scores kept at D^-1/2 (a planted fault)."""
    d = q.shape[-1]
    ext = [torch.cat([x, torch.cat([x[:, :, 1:, :8], torch.zeros_like(x[:, :, :1, :8])], 2)], -1)
           for x in (q, k, v, dout)]
    c = ((d + 8) / d) ** 0.5
    dq = wa.window_attention_bwd_torch(ext[0] * c, *ext[1:3], ids, ext[3])[0]
    return (dq[..., :d].float() * c).to(q.dtype)


def k6_family_cases(dev, gen, results) -> None:
    """21a: K2's exact mode (out, lse) and K6's dq and dk/dv against their
    plain versions at K6_FAMILY_CASES, each with its bound and SDPA's
    forward (+ backward) as the library time. At the first case (head_dim
    72, W = 352): with the odd heads' q, k, v, dout scaled by 8, the even
    heads' out, lse, dq, dk, dv stay bit-equal; and three planted faults
    must fail the bound: dq over 8 columns of the next head, dq from delta
    = 0, dk/dv with frame 0's segment mask ignored."""
    heads = 16
    for i, (suffix, n, w, d, pad) in enumerate(K6_FAMILY_CASES):
        ids = torch.ones((n, w), dtype=torch.int32, device=dev)
        ids[0, w - pad:] = 0
        q, k, vv, do = (torch.randn((n, w, heads, d), generator=gen, device=dev)
                        for _ in range(4))
        q, k, vv = (x.to(torch.bfloat16) for x in (q, k, vv))
        do = (DOUT_SCALE * do).to(torch.bfloat16)
        do[ids == 0] = 0  # the tower never reads a pad row
        seg = segment_mask(ids)
        pairs = segment_pairs(ids) * heads * d
        rows = (ids != 0, (ids != 0)[:, None, :].expand(-1, heads, -1))
        case = f"head_dim {d}, W = {w}" + (", streamed" if w > 768 else "")
        compare("window_attention_exact" + suffix,
                lambda: wa.window_attention_exact(q, k, vv, ids),
                lambda: wa.window_attention_exact_torch(q, k, vv, ids), rows, results,
                flops=4 * pairs, moved=nbytes(q, k, vv, ids, q) + 4 * q.numel() // d,
                library_fn=lambda: sdpa_masked(q, k, vv, seg), case=case)
        out, lse = wa.window_attention_exact(q, k, vv, ids)
        ops = wa.bwd_operands(q, k, vv, ids, out, lse, do)
        ins = nbytes(*ops)
        ref_dq = compare("window_attention_bwd_dq" + suffix, lambda: wa.window_attention_bwd_dq(ops),
                         lambda: wa.window_attention_bwd_torch(q, k, vv, ids, do)[0], None,
                         results, flops=6 * pairs, moved=ins + nbytes(q), case=case,
                         library_fn=lambda: sdpa_fwd_bwd(q, k, vv, do, attn_mask=seg))
        ref_dkv = compare("window_attention_bwd_dkv" + suffix,
                          lambda: wa.window_attention_bwd_dkv(ops),
                          lambda: wa.window_attention_bwd_torch(q, k, vv, ids, do)[1:], None,
                          results, flops=8 * pairs, moved=ins + 2 * nbytes(q), case=case,
                          library_fn=lambda: sdpa_fwd_bwd(q, k, vv, do, attn_mask=seg))
        if i == 0:
            name = "window_attention_bwd_dq" + suffix
            planted(name, "8 columns of the next head in the products over D",
                    neighbour_leak_dq(q, k, vv, ids, do), ref_dq, None)
            planted(name, "delta = 0", window_dq_delta0(q, k, vv, ids, do), ref_dq, None)
            ignored = ids.clone()
            ignored[0] = 1
            planted("window_attention_bwd_dkv" + suffix, "frame 0's segment mask ignored",
                    wa.window_attention_bwd_torch(q, k, vv, ignored, do)[1:], ref_dkv, None)
            base = (out, lse, wa.window_attention_bwd_dq(ops), *wa.window_attention_bwd_dkv(ops))
            loud = [x.clone() for x in (q, k, vv, do)]
            for x in loud:
                x[:, :, 1::2] *= 8
            lout, llse = wa.window_attention_exact(*loud[:3], ids)
            lops = wa.bwd_operands(*loud[:3], ids, lout, llse, loud[3])
            again = (lout, llse, wa.window_attention_bwd_dq(lops), *wa.window_attention_bwd_dkv(lops))
            torch.cuda.synchronize()
            same = all(torch.equal(a[:, 0::2], b[:, 0::2]) if a.dim() == 3 else
                       torch.equal(a[:, :, 0::2], b[:, :, 0::2]) for a, b in zip(base, again))
            log("kernels", name="window_attention_exact" + suffix,
                check="odd heads x8, even heads' out, lse, dq, dk, dv bit-equal", equal=same)
            if not same:
                raise RuntimeError("21a: a head's outputs depend on its neighbour's columns")
            del base, loud, lops, again, ignored
        del q, k, vv, do, out, lse, ops, ref_dq, ref_dkv, seg
    torch.cuda.empty_cache()


def family_sft_steps(tag, params, cfg, batch, steps, required, absent=WINDOW_ROW_KERNELS,
                     phase="train_families") -> dict:
    """`steps` full fine-tune steps through make_train_step (SFTConfig
    defaults: AdamW at lr 1e-6, remat on), the launch counts set to 0 just
    before and read just after: each of ``required`` launched, those of
    ``absent`` (K1 and K6's fused backward) never. Per step the seconds,
    loss, gradient norm and peak GiB. Frees the optimizer state; returns
    the launches."""
    train_cfg = SFTConfig()
    opt = make_optimizer(train_cfg)
    P.trainable(params)
    state = opt.init(params)
    step = make_train_step(cfg, train_cfg, opt)
    log(phase, model=tag, target_tokens=int((batch["labels"][:, 1:] != -100).sum()),
        **batch_vision(batch), params=P.count(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    metrics = []
    for i in range(steps):
        t0 = time.perf_counter()
        _, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        m = {k: float(x) for k, x in m.items()}
        metrics.append(m)
        log(phase, model=tag, step=i + 1, seconds=round(time.perf_counter() - t0, 3),
            loss=m["loss"], grad_norm=m["grad_norm"],
            peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    launches = {name: kernels.LAUNCHES[name] for name in TPU_KERNELS}
    log(phase, model=tag, launches_per_step={k: n / steps for k, n in launches.items() if n})
    del state, opt, step
    for x in P.leaves(params):
        x.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        raise RuntimeError(f"{phase} {tag}: non-finite loss or gradient norm: {metrics}")
    missing = [name for name in required if not launches[name]]
    extra = [name for name in absent if launches[name]]
    if missing or extra:
        raise RuntimeError(f"{phase} {tag}: never launched {missing}, launched {extra}")
    return launches


def training_families_phase(dev, seed: int, results: dict) -> dict:
    """Phase 21: 21a K2's exact mode and K6 at head_dim 72 and at Qwen2-VL's
    80; 21b Qwen3-VL-8B full fine-tune steps at full width and depth, then
    the training numerics at a cut; 21c its PEFT steps; 21d a PEFT GSPO
    step of it, then a full fine-tune GSPO step at a cut; 21e a full
    fine-tune step of Qwen2-VL-7B. Each model is freed before the next is
    drawn. Returns the launches of each new kernel row's main path (21b's
    steps for the rows at 72, 21e's for Qwen2-VL's)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k6_family_cases(dev, gen, results)
    t_a = time.perf_counter()

    cfg3 = Qwen25VLConfig.from_hf_dict(QWEN3_VL_8B_INSTRUCT_CONFIG)
    proc3 = O3VideoProcessor(patch_size=cfg3.vision.patch_size)
    batch = sft_batch(proc3, cfg3, seed, (Q3_FRAME_H, Q3_FRAME_W))
    params = P.init(cfg3, seed, dev)
    launches3 = family_sft_steps("Qwen3-VL-8B", params, cfg3, batch, Q3_SFT_STEPS,
                                 FAMILY_FT_KERNELS)
    train_numerics_phase(params, cfg3, batch, Q3_CUT_VIT, Q3_CUT_TEXT, tag="train_families")
    t_b = time.perf_counter()
    sft_peft_phase(params, cfg3, batch, seed, "16 frames of 256x352", steps=Q3_PEFT_STEPS,
                   required=FAMILY_PEFT_KERNELS,
                   absent=TRAIN_FAMILY_ROWS + WINDOW_ROW_KERNELS, tag="train_families")
    t_c = time.perf_counter()
    sample = gspo_sample(proc3, seed, (Q3_FRAME_H, Q3_FRAME_W))
    trainer = GSPOTrainer(params, None, cfg3, GSPOConfig(), detokenize=CannedTraces(proc3),
                          lora=LoraConfig(seed=seed), seed=seed)
    peft = gspo_step(trainer, sample, 0, "Qwen3-VL-8B PEFT", FAMILY_GSPO_KERNELS)
    if any(peft["launches"][name] for name in TRAIN_FAMILY_ROWS):
        raise RuntimeError("21d: the frozen tower ran K2's exact mode or K6 under PEFT")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    gspo_full_phase(params, cfg3, proc3, sample, seed, Q3_CUT_VIT, Q3_FT_TEXT,
                    FAMILY_GSPO_KERNELS + TRAIN_FAMILY_ROWS, tag="Qwen3-VL-8B full fine-tune")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t_d = time.perf_counter()

    cfg2 = Qwen25VLConfig.from_hf_dict(QWEN2_VL_7B_INSTRUCT_CONFIG)
    params = P.init(cfg2, seed, dev)
    launches2 = family_sft_steps("Qwen2-VL-7B", params, cfg2, sft_batch(O3VideoProcessor(), cfg2,
                                                                       seed),
                                 Q2_SFT_STEPS, FAMILY_FT_KERNELS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("train_families", phase_seconds={
        "21a": round(t_a - t_phase, 3), "21b": round(t_b - t_a, 3), "21c": round(t_c - t_b, 3),
        "21d": round(t_d - t_c, 3), "21e": round(time.perf_counter() - t_d, 3),
        "21": round(time.perf_counter() - t_phase, 3)})
    return {**{name + "_d72": launches3[name] for name in TRAIN_FAMILY_ROWS},
            **{name + "_qwen2vl": launches2[name] for name in TRAIN_FAMILY_ROWS}}


# Phase 22: Qwen3-VL-30B-A3B and Aria served from their published configs
# (random bf16 weights from --seed). 22a serves the 30B on phase 20's
# requests (K2 at 72 in its tower, K3 at 32/4 heads, the routed experts);
# 22b serves Aria: one 980x980 image through its tower and projector, the
# features entering the engine as Request.vision_embeds beside a text-only
# request and a second image request sharing a prefix with the first.
# Their parameter counts as HF's models at these configs have them, counted
# on the meta device (Aria's less the tower's post-layernorm, 2 x 1152,
# which the features never pass and the port does not hold); Aria's model
# card says 25.3B, the phase allows 5% off it.
QWEN3_MOE_HF_PARAMS = 31_070_754_032
ARIA_HF_PARAMS = 25_307_311_216 - 2 * 1152
ARIA_CARD_PARAMS, ARIA_CARD_SLACK = 25.3e9, 0.05
# 22a's numerics: the routed MLP of the first MOE_NUMERICS_LAYERS decoder
# layers over a request of MOE_NUMERICS_FRAMES frames of phase 20's size
# (1244 tokens).
MOE_NUMERICS_FRAMES, MOE_NUMERICS_LAYERS = 4, 2
# Aria's prompts: random ids from --seed in [ARIA_FIRST_ID, vocab), past its
# special ids (the image token is 9): ARIA_TEXT text tokens, then the
# image's 256 query rows, then ARIA_QUESTION tokens; the second image
# request shares all but its last ARIA_TAIL tokens with the first; the text
# request has ARIA_TEXT_ONLY tokens. The suffixes are longer than 8 tokens,
# so that their admission runs K3 (8 rows or fewer take the decode path).
ARIA_FIRST_ID, ARIA_TEXT, ARIA_QUESTION, ARIA_TAIL, ARIA_TEXT_ONLY = 10, 48, 32, 12, 300
ARIA_KERNELS = ("flash_attention_gqa",)


def moe_fault_route(p, t, flat, fault):
    """A wrong routing of 22a's planted faults: ``"no_renorm"`` the top-k of
    the softmax over all experts, not renormalised; ``"softmax_of_probs"``
    Aria's softmax over the top k taken of those probabilities instead of
    the logits. (Aria's routing proper, a softmax over the top-k logits, is
    the same function as Qwen3-VL-MoE's in exact arithmetic.)"""
    logits = quant.dense(flat, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :t.moe_topk], idx[:, :t.moe_topk]
    if fault == "no_renorm":
        return idx, top
    if fault == "softmax_of_probs":
        return idx, torch.softmax(top, dim=-1)
    a_top, a_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return a_idx[:, :t.moe_topk], torch.softmax(a_top[:, :t.moe_topk], dim=-1)


def moe_unsorted(p, t, x, route):
    """The routed MLP with its last step left out: the experts' outputs,
    sorted by expert, weighted and summed as if in token order (the
    inverse permutation missing)."""
    idx, w = route
    flat = x.reshape(-1, x.shape[-1])
    order, offs = TT.expert_groups(idx, t.moe_num_experts)
    out = TT._experts(flat[order // idx.shape[1]], p["moe_fc1"], p["moe_fc2"], offs)
    y = (out.reshape(*idx.shape, -1).float() * w.to(x.dtype).float()[..., None]).sum(1)
    return y.to(x.dtype).reshape(x.shape)


def moe_numerics(params, cfg, proc, seed: int) -> None:
    """22a's numerics at MOE_NUMERICS_LAYERS decoder layers: each layer's MLP
    input over a request of MOE_NUMERICS_FRAMES frames (its tower's
    embeddings merged, recorded in a forward of the cut model), then the
    routed MLP in bf16 (the served form) and JAX's dense form in bf16 (the
    plain one), each against the dense form in float32 on the same weights
    and the bf16 router's experts (so that a near-tie resolved the other
    way in float32 is not counted as error). The routed form may be at most
    SLICE_REL_RATIO further from float32 than the plain one; three planted
    faults must exceed that bound: the renormalisation skipped, Aria's
    softmax taken of the probabilities, the inverse permutation left out.
    Aria's routing in place of Qwen's is logged: the same function in exact
    arithmetic, it must stay within the bound."""
    dev = params["text"]["embed_tokens"].device
    t = cfg.text
    rng = np.random.default_rng(seed + 4)
    req = frames_request(proc, cfg, rng.integers(0, 256, size=(MOE_NUMERICS_FRAMES, 3, Q3_FRAME_H,
                                                               Q3_FRAME_W), dtype=np.uint8),
                         QUESTIONS[0])
    cut = _cut_cfg(cfg, cfg.vision.depth, MOE_NUMERICS_LAYERS)
    ids = np.asarray([req.input_ids])
    pos, _ = get_rope_index(cut, ids, image_grid_thw=req.grid_thw)
    inputs = []
    real = TT._mlp

    def record(p, c, x, impl):
        inputs.append(x.detach().reshape(-1, x.shape[-1]))
        return real(p, c, x, impl)

    TT._mlp = record
    try:
        with torch.inference_mode():
            model_forward(_sub(params, cfg.vision.depth, MOE_NUMERICS_LAYERS, cfg.vision), cut,
                          torch.from_numpy(ids).to(dev), torch.from_numpy(pos).to(dev),
                          pixel_patches=torch.from_numpy(req.pixel_patches).to(dev),
                          grid_thw=req.grid_thw, vision_token_id=cfg.image_token_id,
                          return_hidden=True)
    finally:
        TT._mlp = real
    for li, x in enumerate(inputs):
        p = params["text"]["layers"][li]
        with torch.inference_mode():
            route = TT.moe_route(p, t, x)
            ref = TT.moe_mlp_dense(_cast(p, torch.float32), t, x.float(), route=route)

            def rel(y):
                return _agreement(y.float(), ref)[0]

            routed, plain = rel(TT.moe_mlp(p, t, x)), rel(TT.moe_mlp_dense(p, t, x))
            bound = SLICE_REL_RATIO * plain
            faults = {f: rel(TT.moe_mlp(p, t, x, route=moe_fault_route(p, t, x, f)))
                      for f in ("no_renorm", "softmax_of_probs", "aria_routing")}
            faults["unsorted"] = rel(moe_unsorted(p, t, x, route))
        log("moe_families", numerics=f"layer {li} MLP", tokens=x.shape[0],
            experts_used=int(torch.unique(route[0]).numel()), routed_vs_f32_rel=routed,
            plain_vs_f32_rel=plain, bound=bound, faults_vs_f32_rel=faults)
        if not (routed <= bound and torch.isfinite(ref).all()):
            raise RuntimeError(f"22a layer {li}: the routed MLP is further from float32 than "
                               f"the dense bf16 form ({routed} vs {plain})")
        for f, r in faults.items():
            if (f == "aria_routing") != (r <= bound):
                raise RuntimeError(f"22a layer {li}: planted {f} gave {r} against bound {bound}")
        del ref
    torch.cuda.empty_cache()


def moe_decode_bytes(cfg, rows: int) -> dict:
    """The weight bytes a decode step of ``rows`` rows reads at most in the
    routed form (each row's top-k experts distinct, every layer) and in the
    dense form (every expert), plus the rest of the decoder (attention,
    norms, the lm_head), in bf16."""
    t = cfg.text
    expert = 3 * t.hidden_size * t.moe_intermediate_size * 2
    attn = 2 * t.hidden_size * (t.num_attention_heads + t.num_key_value_heads) * t.head_dim * 2
    rest = t.num_hidden_layers * (attn + t.hidden_size * t.moe_num_experts * 2)
    rest += t.hidden_size * t.vocab_size * 2
    return {"routed_max": rest + t.num_hidden_layers * min(rows * t.moe_topk,
                                                           t.moe_num_experts) * expert,
            "dense": rest + t.num_hidden_layers * t.moe_num_experts * expert}


def qwen3_moe_phase(dev, seed: int, results: dict) -> dict:
    """22a: Qwen3-VL-30B-A3B-Instruct at its published config: K2 and K3 at
    its shapes against their plain versions, then phase 20's two image
    requests greedy (64 tokens) graphed and eagerly (tokens equal), phase
    20's video request the same way, the launches (K2 27 a tower pass, K3
    48 a prefill forward), and the MLP numerics. Returns the rows'
    launches."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = Qwen25VLConfig.from_hf_dict(QWEN3_VL_30B_A3B_INSTRUCT_CONFIG)
    proc = O3VideoProcessor(patch_size=cfg.vision.patch_size)
    reqs = qwen3_requests(proc, cfg, seed)
    rows = [len(r.input_ids) for r in reqs]
    heads = cfg.vision.num_heads
    ids = torch.ones((N_FRAMES, 352), dtype=torch.int32, device=dev)
    q, k, v = (torch.randn((N_FRAMES, 352, heads, 72), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    seg = segment_mask(ids)
    compare("window_attention_d72_qwen3_moe", lambda: wa.window_attention(q, k, v, ids),
            lambda: wa.window_attention_torch(q, k, v, ids), None, results,
            flops=4 * segment_pairs(ids) * heads * 72, moved=nbytes(q, k, v, ids, q),
            library_fn=lambda: sdpa_masked(q, k, v, seg),
            case="Qwen3-VL-30B-A3B's tower, 16 frames of 16x22 patches, 16 heads of 72")
    del q, k, v, seg
    k3_prefill_case(dev, gen, cfg.text, rows, max(rows) + MAX_TOKENS,
                    "flash_attention_gqa_qwen3_moe", results,
                    case=f"Qwen3-VL-30B-A3B prefill, {len(rows)} x {max(rows)}, 32/4 heads")
    t0 = time.perf_counter()
    params = P.init(cfg, seed, dev)
    torch.cuda.synchronize()
    count = P.count(params)
    log("moe_families", model="Qwen3-VL-30B-A3B", params=count, hf_params=QWEN3_MOE_HF_PARAMS,
        weight_gib=round(quant.param_bytes(params) / 2**30, 3),
        init_s=round(time.perf_counter() - t0, 3))
    if count != QWEN3_MOE_HF_PARAMS:
        raise RuntimeError(f"22a: {count} parameters, HF's model has {QWEN3_MOE_HF_PARAMS}")
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=MAX_TOKENS)
    engine = InferenceEngine(params, cfg)
    outs, _, decode = slice_phase(engine, reqs, greedy, names=FAMILY_KERNELS)
    launches = family_launches("Qwen3-VL-30B-A3B", cfg, decode, cfg.vision.depth, len(reqs),
                               phase="moe_families")
    eager_pair("Qwen3-VL-30B-A3B slice", params, cfg, reqs, greedy, outs, decode)
    video = qwen3_video_request(proc, cfg, seed)
    torch.cuda.reset_peak_memory_stats()
    out, vrun = decode_run(engine, lambda: engine.generate([video], greedy))
    family_launches("Qwen3-VL-30B-A3B video", cfg, vrun, cfg.vision.depth, 1,
                    phase="moe_families")
    log("moe_families", run="Qwen3-VL-30B-A3B video", prompt_tokens=out[0]["num_prompt_tokens"],
        grid=video.grid_thw.tolist(), new_tokens=len(out[0]["token_ids"]),
        vision_ms=round(1e3 * vrun["vision_s"], 3), prefill_ms=round(1e3 * vrun["prefill_s"], 3),
        decode_ms_per_token=vrun["ms_per_token"],
        peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    eager_pair("Qwen3-VL-30B-A3B video", params, cfg, [video], greedy, out, vrun)
    log("moe_families", model="Qwen3-VL-30B-A3B",
        decode_weight_bytes=moe_decode_bytes(cfg, len(reqs)),
        first_token_ids=[o["token_ids"][:8] for o in outs])
    moe_numerics(params, cfg, proc, seed)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"window_attention_d72_qwen3_moe": launches["window_attention"],
            "flash_attention_gqa_qwen3_moe": launches["flash_attention_gqa"]}


def aria_image(cfg, seed: int) -> torch.Tensor:
    """One synthetic uint8 image of cfg.vision.image_size squared, as Aria's
    processor normalises it ((x / 255 - 0.5) / 0.5), (1, 3, S, S) float32."""
    s = cfg.vision.image_size
    img = np.random.default_rng(seed + 2).integers(0, 256, size=(1, 3, s, s), dtype=np.uint8)
    return torch.from_numpy(img).float() / 127.5 - 1.0


def aria_requests(cfg, feats, seed: int) -> list[Request]:
    """22b's requests: a text-only one, and two over the same image
    features (``vision_embeds``) that share all but their last ARIA_TAIL
    tokens, so that the engine serves them through one prefix block."""
    rng = np.random.default_rng(seed + 3)
    vocab = cfg.text.vocab_size

    def text(n):
        return rng.integers(ARIA_FIRST_ID, vocab, size=n).tolist()

    head = text(ARIA_TEXT) + [cfg.image_token_id] * feats.shape[0] + text(ARIA_QUESTION)
    return [Request(text(ARIA_TEXT_ONLY))] + [
        Request(head + text(ARIA_TAIL), vision_embeds=feats, vision_token_id=cfg.image_token_id)
        for _ in range(2)]


def aria_last_logits(params, cfg, req, tokens) -> torch.Tensor:
    """The last-position logits of ``req``'s prompt followed by ``tokens``
    (its features merged), one plain forward."""
    dev = params["text"]["embed_tokens"].device
    ids = np.asarray([list(req.input_ids) + list(tokens)])
    embeds = embed_tokens(params, torch.from_numpy(ids).to(dev))
    if req.vision_embeds is not None:
        row = build_vision_row_index(ids, cfg.image_token_id, [0])
        embeds = merge_vision_embeddings_by_index(embeds, req.vision_embeds,
                                                  torch.from_numpy(row).to(dev))
    pos = torch.from_numpy(aria.get_rope_index(cfg, ids)).to(dev)
    with torch.inference_mode():
        hidden, _ = text_forward(params["text"], cfg.text, embeds, pos)
        return logits_from_hidden(params["text"], hidden[:, -1]).float()


def aria_phase(dev, seed: int) -> dict:
    """22b: Aria at its published config: one image through the tower and
    projector (get_image_features), then three requests greedy (64 tokens)
    through InferenceEngine.generate, the two image requests by
    vision_embeds over one prefix block: graphed and eagerly (tokens
    equal), K3 28 a prefill forward, and the prefix-served request against
    the same request served plain (equal tokens, or a first divergence
    where the plain path's top-2 logit gap is at most SPEC_TIE_GAP).
    Returns K3's launches."""
    cfg = aria.AriaConfig.from_hf_dict(aria.ARIA_CONFIG)
    t0 = time.perf_counter()
    params = aria.params.init(cfg, seed, dev)
    torch.cuda.synchronize()
    count = P.count(params)
    log("moe_families", model="Aria", params=count, hf_params=ARIA_HF_PARAMS,
        card_params=ARIA_CARD_PARAMS, weight_gib=round(quant.param_bytes(params) / 2**30, 3),
        init_s=round(time.perf_counter() - t0, 3))
    if count != ARIA_HF_PARAMS or abs(count / ARIA_CARD_PARAMS - 1) > ARIA_CARD_SLACK:
        raise RuntimeError(f"22b: {count} parameters, HF's model {ARIA_HF_PARAMS}, the card "
                           f"{ARIA_CARD_PARAMS}")
    pix = aria_image(cfg, seed).to(dev)
    with torch.inference_mode():
        feats = aria.get_image_features(params, cfg, pix)  # compiled paths warm
        tower = time_ms(lambda: aria.get_image_features(params, cfg, pix), reps=3, warmup=1)
    if feats.shape != (cfg.query_num(cfg.vision.num_patches_per_side ** 2), cfg.text.hidden_size) \
            or not torch.isfinite(feats).all():
        raise RuntimeError(f"22b: image features {tuple(feats.shape)}, finite "
                           f"{bool(torch.isfinite(feats).all())}")
    reqs = aria_requests(cfg, feats, seed)
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=MAX_TOKENS)
    engine = InferenceEngine(params, cfg)
    outs, _, decode = slice_phase(engine, reqs, greedy, names=ARIA_KERNELS)
    sched = decode["scheduler"]
    want = cfg.text.num_hidden_layers * sched["prefills"]
    got = kernels.LAUNCHES["flash_attention_gqa"]
    log("moe_families", model="Aria", tower_projector_ms=round(statistics.median(tower), 3),
        patches=cfg.vision.num_patches_per_side ** 2, queries=feats.shape[0],
        prompt_tokens=[o["num_prompt_tokens"] for o in outs],
        prefill_ms=round(1e3 * decode["prefill_s"], 3), vision_ms=round(1e3 * decode["vision_s"], 3),
        decode_ms_per_token=decode["ms_per_token"], peak_gib=round(
            torch.cuda.max_memory_allocated() / 2**30, 3),
        k3_launches=got, expected=want, prefills=sched["prefills"],
        prefix_blocks=sched["prefix_blocks"], prefix_hits=sched["prefix_hits"],
        tower_passes=sched["tower_passes"], upload_bytes=sched["upload_bytes"])
    if (got != want or sched["tower_passes"] or sched["upload_bytes"]
            or sched["prefix_blocks"] + sched["prefix_hits"] != 1):
        raise RuntimeError(f"22b: K3 {got} (expected {want}), scheduler {dict(sched)}")
    eager_pair("Aria", params, cfg, reqs, greedy, outs, decode)
    plain = InferenceEngine(params, cfg, prefix_cache_min=0)
    alone = plain.generate([reqs[2]], greedy)[0]["token_ids"]
    served = outs[2]["token_ids"]
    k = next((i for i, (a, b) in enumerate(zip(alone, served)) if a != b), None)
    gap = None
    if k is not None:
        top = aria_last_logits(params, cfg, reqs[2], alone[:k])[0].topk(2).values
        gap = float(top[0] - top[1])
    log("moe_families", run="Aria prefix-served vs plain", identical_tokens=served == alone,
        first_divergence=k, plain_top2_gap=gap, bound=SPEC_TIE_GAP,
        first_token_ids=[o["token_ids"][:8] for o in outs])
    if k is not None and gap > SPEC_TIE_GAP:
        raise RuntimeError(f"22b: the prefix-served tokens leave the plain ones at step {k}, "
                           f"where the plain top-2 gap {gap} exceeds {SPEC_TIE_GAP}")
    del engine, plain, params, feats
    gc.collect()
    torch.cuda.empty_cache()
    return got


def aria_k3_case(dev, seed: int, results: dict) -> None:
    """22c: K3 at Aria's prefill, 20 q heads over 20 KV heads of 128 (a GQA
    group of 1), the three requests' rows left-padded as the engine lays
    them out, against its plain version, with its bound and SDPA."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = aria.AriaConfig.from_hf_dict(aria.ARIA_CONFIG)
    feats = torch.zeros((cfg.max_query_num, cfg.text.hidden_size))
    rows = [len(r.input_ids) for r in aria_requests(cfg, feats, seed)]
    k3_prefill_case(dev, gen, cfg.text, rows, max(rows) + MAX_TOKENS, "flash_attention_gqa_aria",
                    results, case=f"Aria prefill, {len(rows)} x {max(rows)}, 20/20 heads")


def moe_families_phase(dev, seed: int, results: dict) -> dict:
    """Phase 22: 22a Qwen3-VL-30B-A3B, 22b Aria, 22c K3 at Aria's group of
    1. Each model is freed before the next is drawn. Returns the launches
    of the phase's kernel rows on their main paths."""
    t_phase = time.perf_counter()
    launches = qwen3_moe_phase(dev, seed, results)
    t_a = time.perf_counter()
    launches["flash_attention_gqa_aria"] = aria_phase(dev, seed)
    t_b = time.perf_counter()
    aria_k3_case(dev, seed, results)
    log("moe_families", phase_seconds={"22a": round(t_a - t_phase, 3), "22b": round(t_b - t_a, 3),
                                       "22c": round(time.perf_counter() - t_b, 3),
                                       "22": round(time.perf_counter() - t_phase, 3)})
    return launches


# Phase 23: training Qwen3-VL-30B-A3B and Aria from their published configs
# (random bf16 weights from --seed). Their full weights take 57.874 and
# 47.139 GiB, so PEFT trains at full width and depth and a full fine-tune at
# a cut depth with every expert of each kept layer. 23a: the 30B, 2 PEFT
# SFT steps on phase 21's batch (16 frames of 256x352, 2762 tokens), a PEFT
# GSPO step at GSPOConfig's defaults on phase 21's sample, then at the 8B's
# tower cut and MOE_FT_TEXT decoder layers 3 full fine-tune SFT steps, the
# training numerics, the routed MLP's gradients and a full fine-tune GSPO
# step. 23b: Aria the same way on one 980x980 image inside ~300 text tokens
# (ARIA_SFT_PROMPT before its 256 query rows, ARIA_SFT_ANSWER supervised
# after), its GSPO prompt ARIA_GSPO_QUESTION tokens more. Aria's tower keeps
# every block's float32 softmax for the backward (no per-block remat, as in
# JAX): 2.478 GiB held a block at 980x980 on an H100 (aria_train_phase
# logs it), 66.9 GiB for the 27; its full fine-tune cut
# is ARIA_FT_VIT blocks and ARIA_FT_TEXT layers, so that the float32
# numerics (a float32 copy, its gradients and the tower's float32 scores)
# fit beside the bf16 weights. 23c: K3's exact mode and K5 at the two
# models' training shapes, and K4 at Aria's group of 1.
MOE_PEFT_STEPS, MOE_FT_STEPS, MOE_FT_TEXT = 2, 3, 4
ARIA_FT_VIT, ARIA_FT_TEXT = 4, 2
ARIA_SFT_PROMPT, ARIA_SFT_ANSWER, ARIA_GSPO_QUESTION = 150, 150, 32
# The routed MLP's gradients are held to the dense form's over the first
# MOE_NUMERICS_LAYERS layers' inputs of a MOE_GRAD_TOKENS-token request
# (phase 22a's 4 frames for the 30B; Aria's image inside text).
MOE_GRAD_TOKENS = 1244
MOE_GRAD_LEAVES = ("router", "moe_fc1", "moe_fc2", "gate_w", "up_w", "down_w")
# K3's exact mode and K5 at each model's SFT shape, each with its row; the
# rows' launches are those of the PEFT SFT steps.
MOE_TRAIN_CASES = {f"{name}_{model}": TPU_KERNELS[name]
                   for model in ("qwen3_moe", "aria") for name in DECODER_TRAIN_KERNELS}
# Under PEFT the 30B's frozen tower runs K2's inference mode alone; no
# tower kernel runs for Aria (plain attention, as in JAX).
FROZEN_TOWER_ABSENT = WINDOW_ROW_KERNELS + TRAIN_FAMILY_ROWS
TOWER_KERNELS = FROZEN_TOWER_ABSENT + ("window_attention",)
ARIA_GSPO_KERNELS = ("flash_attention_gqa",) + DECODER_TRAIN_KERNELS


def moe_train_case(dev, gen, t, batch, model, results, case) -> None:
    """23c: K3's exact mode (out, lse) and K5 (dq; dk, dv) against their
    plain versions at a training batch's length and heads (right-padded
    keys as the batch has them), each with its bound and SDPA's forward
    (+ backward)."""
    L = batch["input_ids"].shape[1]
    valid = torch.ones((1, L), dtype=torch.int32, device=dev)
    if "attn_valid" in batch:
        valid = torch.from_numpy(batch["attn_valid"].astype(np.int32)).to(dev)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None].contiguous()
    Hq, Hkv, D = t.num_attention_heads, t.num_key_value_heads, t.head_dim

    def bf16(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    q, k, vv = bf16(1, L, Hq, D), bf16(1, L, Hkv, D), bf16(1, L, Hkv, D)
    do = bf16(1, L, Hq, D, scale=DOUT_SCALE)
    cpairs = causal_pairs(pos, valid) * Hq * D
    mask = causal_mask(pos, valid)
    rows = valid != 0
    case = f"{case}, 1 x {L}, {Hq}/{Hkv} heads"
    compare(f"flash_attention_gqa_exact_{model}",
            lambda: fa.flash_attention_gqa_exact(q, k, vv, pos, valid),
            lambda: fa.flash_attention_gqa_exact_torch(q, k, vv, pos, valid),
            (rows, rows[:, None, :].expand(-1, Hq, -1)), results, flops=4 * cpairs,
            moved=nbytes(q, k, vv, pos, valid, q) + 4 * q.numel() // D,
            library_fn=lambda: sdpa_masked(q, k, vv, mask), case=case)
    out, lse = fa.flash_attention_gqa_exact(q, k, vv, pos, valid)
    ops = fa.bwd_operands(q, k, vv, pos, valid, out, lse, do)
    ins = nbytes(*ops)
    lib = lambda: sdpa_fwd_bwd(q, k, vv, do, is_causal=True)  # noqa: E731
    compare(f"flash_attention_gqa_bwd_dq_{model}", lambda: fa.flash_attention_gqa_bwd_dq(ops),
            lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[0],
            None, results, flops=6 * cpairs, moved=ins + nbytes(q), library_fn=lib, case=case)
    compare(f"flash_attention_gqa_bwd_dkv_{model}", lambda: fa.flash_attention_gqa_bwd_dkv(ops),
            lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[1:],
            None, results, flops=8 * cpairs, moved=ins + nbytes(k, vv), library_fn=lib, case=case)
    del q, k, vv, do, out, lse, ops, mask
    torch.cuda.empty_cache()


def aria_k4_case(dev, gen, cfg, results) -> None:
    """23c: K4 at Aria's group of 1 (20 q heads over 20 KV heads of 128), a
    decode step over 32768 bf16 slots, against its plain version, with its
    bound and SDPA. Logged only: no phase reaches K4 with Aria (its paths
    stay below 32768 slots), so the row has no main-path launches."""
    t = cfg.text
    T = 32768
    k, v = _layer_views(dev, gen, cfg, 1, T, T - 32, torch.bfloat16)
    q = torch.randn((1, 1, t.num_attention_heads, t.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = torch.full((1, 1), T - 33, dtype=torch.int32, device=dev)
    valid = torch.zeros((1, T), dtype=torch.int32, device=dev)
    valid[:, :T - 32] = 1
    w = T - 32
    mask = causal_mask(pos, valid[:, :w])
    compare("decode_attention_gqa_aria", lambda: da.decode_attention_gqa(q, k, v, pos, valid),
            lambda: da.decode_attention_gqa_torch(q, k[:, :w], v[:, :w], pos, valid[:, :w]),
            None, results, flops=4 * causal_pairs(pos, valid) * t.num_attention_heads * t.head_dim,
            moved=nbytes(q, k[:, :w], v[:, :w], pos, valid) + nbytes(q),
            library_fn=lambda: sdpa_masked(q, k[:, :w], v[:, :w], mask),
            case="Aria, 1 x 32736 of 32768 slots, bf16, 20/20 heads")
    del k, v
    torch.cuda.empty_cache()


def routing_weights(p, t, x, idx) -> torch.Tensor:
    """The router's weights of the experts ``idx`` (moe_route's function
    with the experts given), differentiable in the router and x."""
    logits = quant.dense(x, p["router"]).float()
    if t.moe_routing == "softmax_topk_norm":
        w = torch.softmax(logits, dim=-1).gather(1, idx)
        return w / w.sum(dim=-1, keepdim=True)
    return torch.softmax(logits.gather(1, idx), dim=-1)


def _mlp_grads(fn, p, t, x, dy, idx, dtype, detach=False) -> dict:
    """Gradients of ``fn`` (the routed or the dense form) in ``dtype`` on
    the experts ``idx``: each mixture leaf and the input, the router's
    through the routing weights (``detach``: the weights detached, a
    planted fault that leaves the router without a gradient)."""
    w = {n: p[n].detach().to(dtype).requires_grad_(True) for n in MOE_GRAD_LEAVES if n in p}
    xx = x.detach().to(dtype).requires_grad_(True)
    route = routing_weights(w, t, xx, idx)
    y = fn(w, t, xx, route=(idx, route.detach() if detach else route))
    (y.float() * dy.float()).sum().backward()
    out = {n: (v.grad if v.grad is not None else torch.zeros_like(v)).float() for n, v in w.items()}
    return {**out, "x": xx.grad.float()}


def moe_grad_numerics(params, cfg, ids, pos, vision: dict, tag: str) -> None:
    """The routed MLP's backward at the first MOE_NUMERICS_LAYERS layers:
    each layer's MLP input over ``ids`` (recorded in a forward of those
    layers), a random upstream gradient, the bf16 router's experts; the
    gradients (router, expert stacks, shared experts, input) of the routed
    form in bf16 and of the dense form in bf16 (the plain one), each
    against the dense form in float32: the routed at most SLICE_REL_RATIO
    further (phase 22a's bound); experts that got no token exactly 0 in all
    three; the routing weights detached (a zero router gradient) must
    exceed the bound."""
    dev = params["text"]["embed_tokens"].device
    t = cfg.text
    cut = _cut_cfg(cfg, len(params["visual"]["blocks"]), MOE_NUMERICS_LAYERS)
    inputs, real = [], TT._mlp

    def record(p, c, x, impl):
        inputs.append(x.detach().reshape(-1, x.shape[-1]))
        return real(p, c, x, impl)

    TT._mlp = record
    try:
        with torch.inference_mode():
            family_forward(_sub(params, len(params["visual"]["blocks"]), MOE_NUMERICS_LAYERS,
                                cfg.vision), cut, torch.from_numpy(ids).to(dev),
                           torch.from_numpy(pos).to(dev), return_hidden=True, **vision)
    finally:
        TT._mlp = real
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for li, x in enumerate(inputs):
        x = x.clone()
        p = params["text"]["layers"][li]
        idx = TT.moe_route(p, t, x)[0]
        dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
        ref = _mlp_grads(TT.moe_mlp_dense, p, t, x, dy, idx, torch.float32)
        routed = _mlp_grads(TT.moe_mlp, p, t, x, dy, idx, torch.bfloat16)
        plain = _mlp_grads(TT.moe_mlp_dense, p, t, x, dy, idx, torch.bfloat16)
        fault = _mlp_grads(TT.moe_mlp, p, t, x, dy, idx, torch.bfloat16, detach=True)
        empty = sorted(set(range(t.moe_num_experts)) - set(idx.unique().tolist()))
        zero = all(not g[n][empty].any() for g in (routed, plain, ref)
                   for n in ("moe_fc1", "moe_fc2"))
        rows = {}
        for n in ref:
            rows[n] = (_agreement(routed[n], ref[n])[0], _agreement(plain[n], ref[n])[0],
                       _agreement(fault[n], ref[n])[0])
        log("train_moe_families", model=tag, numerics=f"layer {li} MLP backward",
            tokens=x.shape[0], empty_experts=empty, empty_grads_zero=zero,
            routed_plain_detached_vs_f32_rel=rows, max_ratio=SLICE_REL_RATIO)
        bad = [n for n, (r, pl, _) in rows.items() if not r <= SLICE_REL_RATIO * pl]
        if bad or not zero or not all(torch.isfinite(g).all() for g in routed.values()):
            raise RuntimeError(f"23 {tag} layer {li}: routed gradients {bad} further from float32 "
                               f"than the dense bf16 form's, or an empty expert's not 0 ({zero})")
        r, pl, f = rows["router"]
        if f <= SLICE_REL_RATIO * pl:
            raise RuntimeError(f"23 {tag}: detached routing weights ({f}) pass the bound")
        del ref, routed, plain, fault
    torch.cuda.empty_cache()


def peft_gspo_step(params, cfg, proc, sample, seed, tag, required, absent) -> dict:
    """A PEFT GSPOTrainer step at GSPOConfig's defaults (LoRA rank 16 on
    q/v from --seed, canned traces): the kernels of ``required`` launched,
    those of ``absent`` not; the base unchanged (its fingerprint), the
    adapters' B moved off 0. Returns gspo_step's record."""
    before = fingerprint(params)
    trainer = GSPOTrainer(params, None, cfg, GSPOConfig(), detokenize=CannedTraces(proc),
                          lora=LoraConfig(seed=seed), seed=seed)
    out = gspo_step(trainer, sample, 0, tag, required)
    b_max = max(ab["b"].abs().max().item() for layer in trainer.adapters["layers"]
                for ab in layer.values())
    unchanged = torch.equal(fingerprint(params), before)
    extra = [n for n in absent if out["launches"][n]]
    log("train_moe_families", model=tag, adapters_b_max_abs=b_max,
        base_bit_for_bit_unchanged=unchanged, launched_absent=extra)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if not (b_max > 0 and unchanged) or extra:
        raise RuntimeError(f"23 {tag}: B {b_max}, base unchanged {unchanged}, launched {extra}")
    return out


def peft_expected(cfg, launches, steps, tower_blocks) -> None:
    """The PEFT SFT steps' launches against their count: with remat K3's
    exact mode twice a decoder layer (the forward and its recompute), K5's
    dq and dk/dv once, and K2 once a frozen tower block."""
    n = cfg.text.num_hidden_layers
    want = {"flash_attention_gqa_exact": 2 * n * steps, "flash_attention_gqa_bwd_dq": n * steps,
            "flash_attention_gqa_bwd_dkv": n * steps, "window_attention": tower_blocks * steps}
    got = {k: launches[k] for k in want}
    log("train_moe_families", launches=got, expected=want)
    if got != want:
        raise RuntimeError(f"23: PEFT SFT launches {got}, expected {want}")


def qwen3_moe_train_phase(dev, seed: int, results: dict) -> dict:
    """23a (see the comment above MOE_PEFT_STEPS). Returns the PEFT SFT
    steps' launches of K3's exact mode and K5."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = Qwen25VLConfig.from_hf_dict(QWEN3_VL_30B_A3B_INSTRUCT_CONFIG)
    proc = O3VideoProcessor(patch_size=cfg.vision.patch_size)
    batch = sft_batch(proc, cfg, seed, (Q3_FRAME_H, Q3_FRAME_W))
    moe_train_case(dev, gen, cfg.text, batch, "qwen3_moe", results, "Qwen3-VL-30B-A3B SFT")
    params = P.init(cfg, seed, dev)
    launches = sft_peft_phase(params, cfg, batch, seed, "16 frames of 256x352",
                              steps=MOE_PEFT_STEPS, required=FAMILY_PEFT_KERNELS,
                              absent=FROZEN_TOWER_ABSENT, tag="train_moe_families",
                              copy_base=False)
    peft_expected(cfg, launches, MOE_PEFT_STEPS, cfg.vision.depth)
    sample = gspo_sample(proc, seed, (Q3_FRAME_H, Q3_FRAME_W))
    peft_gspo_step(params, cfg, proc, sample, seed, "Qwen3-VL-30B-A3B PEFT",
                   FAMILY_GSPO_KERNELS, FROZEN_TOWER_ABSENT)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = _cut_cfg(cfg, Q3_CUT_VIT, MOE_FT_TEXT)
    params = P.init(cut, seed, dev)
    family_sft_steps("Qwen3-VL-30B-A3B cut", params, cut, batch, MOE_FT_STEPS, FAMILY_FT_KERNELS,
                     phase="train_moe_families")
    train_numerics_phase(params, cut, batch, Q3_CUT_VIT, MOE_FT_TEXT, tag="train_moe_families")
    rng = np.random.default_rng(seed + 4)
    req = frames_request(proc, cfg, rng.integers(0, 256, size=(
        MOE_NUMERICS_FRAMES, 3, Q3_FRAME_H, Q3_FRAME_W), dtype=np.uint8), QUESTIONS[0])
    ids = np.asarray([req.input_ids])
    pos, _ = get_rope_index(cut, ids, image_grid_thw=req.grid_thw)
    dev_patches = torch.from_numpy(req.pixel_patches).to(dev)
    moe_grad_numerics(params, cut, ids, pos, {"pixel_patches": dev_patches,
                                              "grid_thw": req.grid_thw,
                                              "vision_token_id": cfg.image_token_id},
                      "Qwen3-VL-30B-A3B")
    gspo_full_phase(params, cut, proc, sample, seed, Q3_CUT_VIT, MOE_FT_TEXT,
                    FAMILY_GSPO_KERNELS + TRAIN_FAMILY_ROWS, tag="Qwen3-VL-30B-A3B full fine-tune")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {f"{name}_qwen3_moe": launches[name] for name in DECODER_TRAIN_KERNELS}


def aria_train_batch(cfg, seed: int) -> dict:
    """Aria's SFT batch: ARIA_SFT_PROMPT text tokens, the 980x980 image's
    256 query rows, ARIA_SFT_ANSWER supervised text tokens (random ids from
    --seed past the special ids)."""
    rng = np.random.default_rng(seed + 5)
    vocab = cfg.text.vocab_size
    q = cfg.query_num(cfg.vision.num_patches_per_side ** 2)
    answer = rng.integers(ARIA_FIRST_ID, vocab, size=ARIA_SFT_ANSWER)
    ids = np.concatenate([rng.integers(ARIA_FIRST_ID, vocab, size=ARIA_SFT_PROMPT),
                          np.full(q, cfg.image_token_id), answer])[None]
    labels = np.full_like(ids, -100)
    labels[0, -ARIA_SFT_ANSWER:] = answer
    return {"input_ids": ids, "position_ids": aria.get_rope_index(cfg, ids), "labels": labels,
            "pixel_values": aria_image(cfg, seed).numpy()}


def aria_tower_held(params, cfg, pix) -> float:
    """GiB that the trainable tower and projector keep for their backward
    a block: one forward under autograd, the allocation after it less the
    one before, over the blocks."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    feats = aria.get_image_features(params, cfg, pix)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del feats
    torch.cuda.empty_cache()
    return held / 2**30 / cfg.vision.num_hidden_layers


def aria_train_phase(dev, seed: int, results: dict) -> dict:
    """23b (see the comment above MOE_PEFT_STEPS). Returns the PEFT SFT
    steps' launches of K3's exact mode and K5."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = aria.AriaConfig.from_hf_dict(aria.ARIA_CONFIG)
    batch = aria_train_batch(cfg, seed)
    moe_train_case(dev, gen, cfg.text, batch, "aria", results, "Aria SFT")
    aria_k4_case(dev, gen, cfg, results)
    params = aria.params.init(cfg, seed, dev)
    launches = sft_peft_phase(params, cfg, batch, seed, "one 980x980 image",
                              steps=MOE_PEFT_STEPS, required=DECODER_TRAIN_KERNELS,
                              absent=TOWER_KERNELS, tag="train_moe_families", copy_base=False)
    peft_expected(cfg, launches, MOE_PEFT_STEPS, 0)
    proc = O3VideoProcessor()
    question = np.random.default_rng(seed + 6).integers(ARIA_FIRST_ID, cfg.text.vocab_size,
                                                        size=ARIA_GSPO_QUESTION)
    n_prompt = ARIA_SFT_PROMPT + cfg.query_num(cfg.vision.num_patches_per_side ** 2)
    sample = {"input_ids": batch["input_ids"][0, :n_prompt].tolist() + question.tolist(),
              "pixel_values": batch["pixel_values"],
              "reward_kwargs": gspo_sample(proc, seed)["reward_kwargs"]}
    encodes, real = [], aria.get_image_features

    def counted(*args, **kw):  # the rollout's tower passes (the update's go through forward)
        encodes.append(1)
        return real(*args, **kw)

    aria.get_image_features = counted
    try:
        out = peft_gspo_step(params, cfg, proc, sample, seed, "Aria PEFT", ARIA_GSPO_KERNELS,
                             TOWER_KERNELS)
    finally:
        aria.get_image_features = real
    log("train_moe_families", model="Aria PEFT", rollout_tower_passes=len(encodes),
        rows=len(out["tokens"]))
    if len(encodes) != 1:
        raise RuntimeError(f"23b: {len(encodes)} tower passes for the G rows of one prompt")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = _cut_cfg(cfg, ARIA_FT_VIT, ARIA_FT_TEXT)
    params = P.trainable(aria.params.init(cut, seed, dev))
    held = aria_tower_held(params, cut, torch.from_numpy(batch["pixel_values"]).to(dev))
    log("train_moe_families", model="Aria cut", tower_blocks=ARIA_FT_VIT, decoder_layers=ARIA_FT_TEXT,
        tower_held_gib_a_block=round(held, 3),
        tower_held_gib_27_blocks=round(held * cfg.vision.num_hidden_layers, 3))
    family_sft_steps("Aria cut", params, cut, batch, MOE_FT_STEPS, DECODER_TRAIN_KERNELS,
                     absent=TOWER_KERNELS, phase="train_moe_families")
    train_numerics_phase(params, cut, batch, ARIA_FT_VIT, ARIA_FT_TEXT, tag="train_moe_families")
    rng = np.random.default_rng(seed + 7)
    q = cfg.query_num(cfg.vision.num_patches_per_side ** 2)
    half = (MOE_GRAD_TOKENS - q) // 2
    text = rng.integers(ARIA_FIRST_ID, cfg.text.vocab_size, size=MOE_GRAD_TOKENS - q)
    ids = np.concatenate([text[:half], np.full(q, cfg.image_token_id), text[half:]])[None]
    moe_grad_numerics(params, cut, ids, aria.get_rope_index(cut, ids),
                      {"pixel_values": torch.from_numpy(batch["pixel_values"]).to(dev)}, "Aria")
    gspo_full_phase(params, cut, proc, sample, seed, ARIA_FT_VIT, ARIA_FT_TEXT, ARIA_GSPO_KERNELS,
                    tag="Aria full fine-tune")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {f"{name}_aria": launches[name] for name in DECODER_TRAIN_KERNELS}


def train_moe_families_phase(dev, seed: int, results: dict) -> dict:
    """Phase 23: 23a Qwen3-VL-30B-A3B's training, 23b Aria's, 23c (inside
    each) K3's exact mode and K5 at their training shapes and K4 at Aria's
    group of 1. Each model is freed before the next is drawn. Returns the
    launches of the phase's kernel rows on their main paths."""
    t_phase = time.perf_counter()
    launches = qwen3_moe_train_phase(dev, seed, results)
    t_a = time.perf_counter()
    launches.update(aria_train_phase(dev, seed, results))
    log("train_moe_families", phase_seconds={"23a": round(t_a - t_phase, 3),
                                             "23b": round(time.perf_counter() - t_a, 3),
                                             "23": round(time.perf_counter() - t_phase, 3)})
    return launches


# ---------------------------------------------------------------- phase 24
# Serving on a mesh. 24b's rows: K1 and K2 at 8 and 4 of the tower's 16
# heads (tensor = 2, 4), K3 at the 7B's 14/2 and 7/1 heads and the 72B
# judge's 8/1 (tensor = 8), K4 at 7/1 over 81920 fp8 slots, K7 on the 72B's
# down_w column shard at tensor = 4 (N / 4) by both routes.
MESH_CASES = {
    "fused_window_attention_tp2": TPU_KERNELS["fused_window_attention"],
    "fused_window_attention_tp4": TPU_KERNELS["fused_window_attention"],
    "window_attention_tp2": TPU_KERNELS["window_attention"],
    "window_attention_tp4": TPU_KERNELS["window_attention"],
    "flash_attention_gqa_tp2": TPU_KERNELS["flash_attention_gqa"],
    "flash_attention_gqa_tp4": TPU_KERNELS["flash_attention_gqa"],
    "flash_attention_gqa_judge_tp8": TPU_KERNELS["flash_attention_gqa"],
    "decode_attention_gqa_tp4": TPU_KERNELS["decode_attention_gqa"],
    "int4_matmul_72b_down_tp4": TPU_KERNELS["int4_matmul"],
    "int4_matmul_wgmma_72b_down_tp4": TPU_KERNELS["int4_matmul_wgmma"],
}
# 24c's bound: the two-rank tensor-parallel forward sums o and down as two
# bf16 partials, so it rounds otherwise than the one-rank forward, and two
# bf16 paths that round differently drift apart by a few percent over 60
# random-init layers (phase 5). So, as phase 5 holds the kernel path, the
# two-rank logits of the last MESH_TF_ROWS prompt positions are held to a
# float32 forward of the same weights: at most SLICE_REL_RATIO times the
# one-rank bf16 forward's relative distance from it. Top-1 and greedy
# agreement with the one-rank forward are reported.
MESH_TF_ROWS = 64
MESH_GREEDY_TOKENS = 16


def mesh_kernel_cases(dev, gen, cfg, batch_rows, t_total, results) -> None:
    """24b: each kernel of the mesh path at the shard shapes a tensor group
    gives it, against its plain version, with its bound and library time."""
    v = cfg.vision
    for t in (2, 4):
        heads = v.num_heads // t
        ids, cos, sin, qkv = window_row_inputs(dev, gen, v, WINDOW_ROW_GRIDS[0])
        qkv = qkv[..., :3 * heads * v.head_dim].contiguous()  # this rank's [q|k|v] of `heads`
        rq, rk, rv = wa._rope_qk(qkv, cos, sin, heads)
        seg = segment_mask(ids)
        compare(f"fused_window_attention_tp{t}",
                lambda: wa.fused_window_attention(qkv, cos, sin, ids, heads),
                lambda: wa.fused_window_attention_torch(qkv, cos, sin, ids, heads),
                ids != 0, results, flops=4 * segment_pairs(ids) * heads * v.head_dim,
                moved=nbytes(qkv, cos, sin, ids) + qkv.numel() // 3 * 2,
                library_fn=lambda: sdpa_masked(rq, rk, rv, seg),
                case=f"{heads} of {v.num_heads} heads, W = {ids.shape[1]}")
        frame_ids, q, k, vv, _ = frame_inputs(dev, gen, v, K2_FRAME_GRIDS[0])
        q, k, vv = (x[:, :, :heads].contiguous() for x in (q, k, vv))
        fseg = segment_mask(frame_ids)
        compare(f"window_attention_tp{t}", lambda: wa.window_attention(q, k, vv, frame_ids),
                lambda: wa.window_attention_torch(q, k, vv, frame_ids), frame_ids != 0, results,
                flops=4 * segment_pairs(frame_ids) * heads * v.head_dim,
                moved=nbytes(q, k, vv, frame_ids) + nbytes(q),
                library_fn=lambda: sdpa_masked(q, k, vv, fseg),
                case=f"{heads} of {v.num_heads} heads, W = {frame_ids.shape[1]}")
        del qkv, rq, rk, rv, seg, q, k, vv, fseg
        tt = dataclasses.replace(cfg.text, num_attention_heads=cfg.text.num_attention_heads // t,
                                 num_key_value_heads=cfg.text.num_key_value_heads // t,
                                 explicit_head_dim=cfg.text.head_dim)
        k3_prefill_case(dev, gen, tt, batch_rows, t_total, f"flash_attention_gqa_tp{t}", results,
                        case=f"{tt.num_attention_heads}/{tt.num_key_value_heads} heads")
    jt = Qwen25VLConfig.from_hf_dict(QWEN25_72B_INSTRUCT_CONFIG).text
    jt8 = dataclasses.replace(jt, num_attention_heads=8, num_key_value_heads=1,
                              explicit_head_dim=jt.head_dim)
    k3_prefill_case(dev, gen, jt8, JUDGE_PROMPT_ROWS,
                    max(JUDGE_PROMPT_ROWS) + JUDGE_NEW_TOKENS, "flash_attention_gqa_judge_tp8",
                    results, case="72B judge prefill, 8/1 heads")
    t4 = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_attention_heads=7, num_key_value_heads=1, explicit_head_dim=cfg.text.head_dim))
    T, last = 81920, 81887
    k, vv = _layer_views(dev, gen, t4, 1, T, last + 1, torch.float8_e4m3fn)
    q = torch.randn((1, 1, 7, cfg.text.head_dim), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.full((1, 1), last, dtype=torch.int32, device=dev)
    valid = torch.zeros((1, T), dtype=torch.int32, device=dev)
    valid[:, :last + 1] = 1
    w = last + 1
    kb, vb = k[:, :w].to(torch.bfloat16), vv[:, :w].to(torch.bfloat16)
    mask = causal_mask(pos, valid[:, :w])
    compare("decode_attention_gqa_tp4", lambda: da.decode_attention_gqa(q, k, vv, pos, valid),
            lambda: da.decode_attention_gqa_torch(q, k[:, :w], vv[:, :w], pos, valid[:, :w]),
            None, results, flops=4 * causal_pairs(pos, valid) * 7 * cfg.text.head_dim,
            moved=nbytes(q, k[:, :w], vv[:, :w], pos, valid) + nbytes(q),
            library_fn=lambda: sdpa_masked(q, kb, vb, mask), case="7/1 heads, 81888 of 81920 fp8")
    del k, vv, kb, vb, mask
    K, N = 29568, 8192 // 4  # the 72B's down_w, its output columns over tensor = 4
    for M in (4, 3984):
        x, wq = int4_case(dev, gen, M, K, N)
        wd = i4.dequantize(wq, torch.bfloat16)
        route = i4.kernel_route(M)
        compare(f"{route}_72b_down_tp4", lambda: i4.int4_matmul(x, wq.w_p, wq.scale, wq.group),
                lambda: i4.int4_matmul_torch(x, wq.w_p, wq.scale, wq.group), None, results,
                flops=2 * M * K * N, moved=K * N // 2 + 4 * N * K // 128 + 2 * M * K + 2 * M * N,
                library_fn=lambda: torch.matmul(x, wd), case=f"M={M}, K={K}, N={N} (8192 / 4)")
        del x, wq, wd
    # the gate_w and up_w column shards of the 72B (29568 / t columns) are
    # not multiples of 128 at any tensor > 1: K7 takes JAX's dequantized
    # product there, as JAX's _int4_mm_2d does on its local shapes
    log("mesh", k7_gate_shard_columns={t: 29568 // t for t in (2, 4, 8)},
        k7_eligible={t: i4.kernel_eligible(29568 // t, 128) for t in (2, 4, 8)})
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_serve_pair(params, cfg, reqs, sampling, mesh, tag) -> dict:
    """24a for one set of weights: the mesh-less engine and the one-rank
    mesh engine on the same requests (the mesh's collectives are
    identities, so tokens and log-probabilities must be bit-equal), graphed
    and then eagerly; ms/token of each and the collectives captured in the
    mesh engine's decode graph."""
    out = {}
    for name, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        for graph in (True, False):
            engine = InferenceEngine(params, cfg, decode_graph=graph, **kw)
            engine.generate(reqs, SamplingParams(**{**vars(sampling), "max_tokens": 2}))
            res, dec = decode_run(engine, lambda: engine.generate(reqs, sampling,
                                                                  return_logprobs=True))
            out[(name, graph)] = (res, dec, dict(kernels.LAUNCHES),
                                  dict(getattr(engine, "last_graph_collectives", {})))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    tokens = [o["token_ids"] for o in out[("plain", True)][0]]
    for graph in (True, False):
        plain, on_mesh = out[("plain", graph)][0], out[("mesh", graph)][0]
        if ([o["token_ids"] for o in on_mesh] != [o["token_ids"] for o in plain]
                or [o["logprobs"] for o in on_mesh] != [o["logprobs"] for o in plain]
                or [o["token_ids"] for o in plain] != tokens):
            raise RuntimeError(f"24a {tag}: the mesh engine's tokens or log-probabilities "
                               f"differ from the mesh-less engine's (graphed: {graph})")
    log("mesh", case=f"24a {tag}", bit_equal=True,
        ms_per_token={f"{n} {'graph' if g else 'eager'}": out[(n, g)][1]["ms_per_token"]
                      for n, g in out},
        collectives_per_decode_graph=out[("mesh", True)][3],
        launches={k: v for k, v in out[("mesh", True)][2].items() if v})
    return out[("mesh", True)][2]


def mesh_rank_main(rank: int, world: int, store: str, out_path: str, seed: int) -> None:
    """24c, one of two gloo ranks on the one card: the 7B at full width,
    tensor = 2, eager (a gloo collective cannot be captured): the last
    MESH_TF_ROWS positions' logits of phase 4's first request (teacher
    forced over its prompt) and greedy tokens of both requests."""
    import torch.distributed as dist

    from open_o3_video_tpu_torch.parallel import distributed, make_mesh, shard_params

    distributed.initialize(f"file://{store}", world, rank, device="cpu")  # gloo
    dev = torch.device("cuda")
    mesh = make_mesh(tensor=world, device_type="cuda")
    cfg = Qwen25VLConfig()
    params = P.init(cfg, seed, dev)
    reqs = make_requests(O3VideoProcessor(), cfg, seed)
    engine = InferenceEngine(params, cfg, mesh=mesh, decode_graph=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate(reqs, SamplingParams(temperature=0.0, max_tokens=MESH_GREEDY_TOKENS))
    gen_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    logits = mesh_tf_logits(engine.params, cfg, reqs[0])
    torch.save({"tokens": [o["token_ids"] for o in outs], "logits": logits.cpu(),
                "launches": launches, "generate_s": gen_s,
                "collectives": dict(mesh.collectives),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}, out_path)
    dist.destroy_process_group()


def mesh_tf_logits(params, cfg, req, impl: str = "auto") -> torch.Tensor:
    """The last MESH_TF_ROWS positions' logits of ``req`` (float32), the
    prompt teacher-forced."""
    dev = torch.device("cuda")
    ids = torch.tensor([req.input_ids], device=dev)
    pos, _ = get_rope_index(cfg, np.asarray([req.input_ids]), image_grid_thw=req.grid_thw)
    patches = torch.as_tensor(req.pixel_patches, device=dev, dtype=cfg.dtype)
    with torch.no_grad():
        logits, _ = model_forward(params, cfg, ids, torch.from_numpy(pos).to(dev),
                                  pixel_patches=patches, grid_thw=req.grid_thw, attn_impl=impl)
    return logits[0, -MESH_TF_ROWS:].float()


def mesh_two_ranks(seed: int, ref_logits, f32_logits, ref_tokens) -> dict:
    """24c: two gloo ranks on the card (NCCL refuses two ranks on one
    device; gloo takes CUDA tensors for every collective the path uses, as
    a probe on the card found), each a process of this script."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(r), "--seed", str(seed), "--mesh-store", store,
                                   "--mesh-out", outs[r]]) for r in range(2)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"24c: a rank exited {codes}")
        got = [torch.load(o, weights_only=False) for o in outs]
    ref, f32 = ref_logits.cpu(), f32_logits.cpu()
    one_rank = _agreement(ref, f32)[0]
    two_rank = [_agreement(g["logits"], f32)[0] for g in got]
    top1 = [(g["logits"].argmax(-1) == ref.argmax(-1)).float().mean().item() for g in got]
    greedy = [sum(a == b for a, b in zip(t, r)) / max(len(r), 1)
              for t, r in zip(got[0]["tokens"], ref_tokens)]
    log("mesh", case="24c tensor=2, two gloo ranks on one card, eager",
        one_rank_vs_f32_rel=one_rank, two_rank_vs_f32_rel=two_rank,
        max_ratio=SLICE_REL_RATIO, two_rank_vs_one_rank_rel=_agreement(got[0]["logits"], ref)[0],
        tf_max_abs_diff=[(g["logits"] - ref).abs().max().item() for g in got],
        tf_top1_agreement=top1, greedy_agreement=greedy,
        ranks_same_tokens=got[0]["tokens"] == got[1]["tokens"],
        generate_s=[round(g["generate_s"], 3) for g in got],
        collectives=got[0]["collectives"], peak_gib=[round(g["peak_gib"], 3) for g in got],
        launches={k: v for k, v in got[0]["launches"].items() if v})
    if max(two_rank) > SLICE_REL_RATIO * one_rank or got[0]["tokens"] != got[1]["tokens"]:
        raise RuntimeError("24c: the two-rank forward is further from float32 than the one-rank "
                           f"forward allows ({two_rank} vs {one_rank} x {SLICE_REL_RATIO}), or "
                           "its ranks disagree")
    return got[0]["launches"]


def mesh_gif(outs, reqs, proc) -> None:
    """24d: phase 24a's first answer rendered over its frames as a GIF by
    the visualizer, with jax and PIL blocked (the port imports neither)."""
    import tempfile

    from open_o3_video_tpu_torch.eval.visualization import VideoQAGIFGenerator

    blocked = {m: sys.modules.get(m) for m in ("jax", "PIL")}
    if any(v is not None for v in blocked.values()):
        raise RuntimeError(f"24d: {[m for m, v in blocked.items() if v]} already imported")
    for m in blocked:
        sys.modules[m] = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            video = os.path.join(tmp, "q.avi")
            write_raw_avi(video, slice_frames(0)[0].transpose(0, 2, 3, 1), FPS)
            answer = proc.decode(outs[0]["token_ids"], skip_special_tokens=True)
            response = (f"<think>Seen <obj>ball</obj><box>[20, 30, 120, 140]</box>at<t>1.5</t>s. "
                        f"{answer}</think><answer>{answer[:40]}</answer>")
            t0 = time.perf_counter()
            gif = VideoQAGIFGenerator().create_demo_gif(video, QUESTIONS[0], response,
                                                         os.path.join(tmp, "a.gif"))
            data = open(gif, "rb").read()
            frames = data.count(b"\x21\xf9\x04")  # one graphics control block a frame
            log("mesh", case="24d GIF", frames=frames, bytes=len(data),
                seconds=round(time.perf_counter() - t0, 3))
            if data[:6] != b"GIF89a" or frames < 2:
                raise RuntimeError("24d: no animated GIF written")
    finally:
        for m in blocked:
            del sys.modules[m]


def mesh_phase(dev, seed: int, results: dict) -> dict:
    """Phase 24: 24a the 7B (bf16, then int4) on a one-rank NCCL mesh,
    bit-equal to the mesh-less engine; 24b the kernels at shard shapes;
    24c two gloo ranks on the card at tensor = 2; 24d a GIF. Returns the
    launches of its rows on their main paths (24c's, at tensor = 2)."""
    from open_o3_video_tpu_torch.parallel import distributed, make_mesh

    t_phase = time.perf_counter()
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ["MASTER_PORT"] = str(_free_port())
    distributed.initialize(f"localhost:{os.environ['MASTER_PORT']}", 1, 0, device="cuda")
    mesh = make_mesh()
    cfg = Qwen25VLConfig()
    proc = O3VideoProcessor()
    reqs = make_requests(proc, cfg, seed)
    sampling = SamplingParams(temperature=0.7, top_p=0.001, repetition_penalty=1.05,
                              max_tokens=MAX_TOKENS, seed=seed)
    params = P.init(cfg, seed, dev)
    path_launches = mesh_serve_pair(params, cfg, reqs, sampling, mesh, "bf16")
    greedy = InferenceEngine(params, cfg).generate(
        reqs, SamplingParams(temperature=0.0, max_tokens=MESH_GREEDY_TOKENS))
    ref_tokens = [o["token_ids"] for o in greedy]
    ref_logits = mesh_tf_logits(params, cfg, reqs[0])
    f32_logits = mesh_tf_logits(_cast(params, torch.float32),
                                dataclasses.replace(cfg, dtype=torch.float32), reqs[0], "torch")
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        qparams = i4.quantize_params_int4(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches = mesh_serve_pair(qparams, cfg, reqs, sampling, mesh, "int4")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    for name in SLICE_KERNELS:
        if not path_launches.get(name):
            raise RuntimeError(f"24a: {name} never launched on the mesh: {path_launches}")
    if not all(int4_launches.get(name) for name in K7_ROUTES):
        raise RuntimeError(f"24a int4: K7 never launched on the mesh: {int4_launches}")
    t_a = time.perf_counter()
    rows = [len(r.input_ids) for r in reqs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 24)
    mesh_kernel_cases(dev, gen, cfg, rows, max(rows) + MAX_TOKENS, results)
    t_b = time.perf_counter()
    tp2 = mesh_two_ranks(seed, ref_logits, f32_logits, ref_tokens)
    t_c = time.perf_counter()
    mesh_gif(greedy, reqs, proc)
    import torch.distributed as dist

    dist.destroy_process_group()
    log("mesh", phase_seconds={"24a": round(t_a - t_phase, 3), "24b": round(t_b - t_a, 3),
                               "24c": round(t_c - t_b, 3),
                               "24": round(time.perf_counter() - t_phase, 3)})
    launches = {name: 0 for name in MESH_CASES}  # tensor 4 and 8 need 4 and 8 cards
    launches.update({f"{name}_tp2": tp2.get(name, 0) for name in SLICE_KERNELS})
    return launches


# ---------------------------------------------------------------- phase 25
# Training on a mesh. 25b's rows: K5 at the 7B's 14/2 and 7/1 heads (tensor
# = 2, 4) at the SFT slice's length, K6's fused backward at 8 and 4 of the
# tower's 16 heads (D 80, W = 64), K6's whole-frame backward at 8 and 4
# heads at D 80 (phase 8's frames) and D 72 (Qwen3-VL's, K6_FAMILY_CASES[0]).
# 25d's rows: one step of the ring at context 2 over RING_TOKENS tokens of
# the 7B's attention (28/4 heads): rank 1's queries meet rank 0's block
# (the query positions shifted by the block's first key position, 0, so
# every key is visible): K3's exact mode, then K5 with the combined output
# and lse on that block.
TRAIN_MESH_CASES = {
    **{f"flash_attention_gqa_bwd_{p}_tp{t}": TPU_KERNELS[f"flash_attention_gqa_bwd_{p}"]
       for t in (2, 4) for p in ("dq", "dkv")},
    **{f"fused_window_attention_bwd_tp{t}": TPU_KERNELS["fused_window_attention_bwd"]
       for t in (2, 4)},
    **{f"window_attention_bwd_{p}{d}_tp{t}": TPU_KERNELS[f"window_attention_bwd_{p}"]
       for d in ("", "_d72") for t in (2, 4) for p in ("dq", "dkv")},
    "flash_attention_gqa_exact_ring": TPU_KERNELS["flash_attention_gqa_exact"],
    "flash_attention_gqa_bwd_dq_ring": TPU_KERNELS["flash_attention_gqa_bwd_dq"],
    "flash_attention_gqa_bwd_dkv_ring": TPU_KERNELS["flash_attention_gqa_bwd_dkv"],
}
# 25c and 25e run the 7B at full width with its depth cut to
# MESH_TRAIN_DEPTH (ViT blocks, decoder layers); 25a runs it whole.
MESH_TRAIN_DEPTH = (8, 4)
MESH_TRAIN_LR = 1e-4  # an update that moves B off 0 (SFTConfig's 1e-6 is under bf16's reach)
MESH_GSPO_TOKENS = 64  # the replayed rollouts' length
RING_TOKENS = 16384
RING_PLAIN_REPS = 3  # the plain versions at 8192 x 8192 take 60-110 ms a call
PIPE_ROWS, PIPE_TOKENS = 4, 256  # 25e: 2 microbatches of 2 rows
# 25c's bound on the gradient norm: the two-rank step's relative distance
# from the float32 one-rank step, at most SLICE_REL_RATIO times the
# one-rank bf16 step's, or bf16's relative spacing 2^-8 where that is
# smaller (two bf16 paths that round otherwise). Its bound on the updated
# adapters (bf16): AdamW's first update is lr * g / (|g| + eps), so an
# element whose gradient's sign rounds the other way moves 2 lr, and bf16
# stores each adapter to its spacing at the leaf's largest magnitude.
MESH_NORM_FLOOR = 2.0 ** -8


def _bf16_spacing(x: torch.Tensor) -> float:
    return 2.0 ** (float(torch.log2(x.float().abs().max().clamp(min=1e-30)).floor()) - 7)


def adapter_bound(adapters) -> float:
    return 2 * MESH_TRAIN_LR + max(_bf16_spacing(x) for x in adapter_leaves(adapters))


def adapter_gap(adapters, ref) -> float:
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(adapter_leaves(adapters), adapter_leaves(ref)))


def train_mesh_kernel_cases(dev, gen, cfg, batch, results) -> None:
    """25b: K5 and K6 at the shapes each rank of a tensor group gives them,
    against their plain versions, with the bound and SDPA's forward and
    backward as the library time."""
    v, t = cfg.vision, cfg.text
    L = batch["input_ids"].shape[1]
    valid = torch.from_numpy(batch["attn_valid"].astype(np.int32)).to(dev)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None].contiguous()

    def bf16(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    for n in (2, 4):
        hq, hkv = t.num_attention_heads // n, t.num_key_value_heads // n
        q, do = bf16(1, L, hq, t.head_dim), bf16(1, L, hq, t.head_dim, scale=DOUT_SCALE)
        k, vv = (bf16(1, L, hkv, t.head_dim) for _ in range(2))
        out, lse = fa.flash_attention_gqa_exact(q, k, vv, pos, valid)
        ops = fa.bwd_operands(q, k, vv, pos, valid, out, lse, do)
        ins, cpairs = nbytes(*ops), causal_pairs(pos, valid) * hq * t.head_dim
        lib = lambda: sdpa_fwd_bwd(q, k, vv, do, is_causal=True)  # noqa: E731
        case = f"{hq}/{hkv} heads, L = {L}"
        compare(f"flash_attention_gqa_bwd_dq_tp{n}", lambda: fa.flash_attention_gqa_bwd_dq(ops),
                lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[0],
                None, results, flops=6 * cpairs, moved=ins + nbytes(q), library_fn=lib, case=case)
        compare(f"flash_attention_gqa_bwd_dkv_tp{n}", lambda: fa.flash_attention_gqa_bwd_dkv(ops),
                lambda: fa.flash_attention_gqa_bwd_torch(q, k, vv, pos, valid, out, lse, do)[1:],
                None, results, flops=8 * cpairs, moved=ins + nbytes(k, vv), library_fn=lib,
                case=case)
        del q, k, vv, do, out, lse, ops

        heads = v.num_heads // n
        ids, cos, sin, qkv = window_row_inputs(dev, gen, v, WINDOW_ROW_GRIDS[0])
        qkv = qkv[..., :3 * heads * v.head_dim].contiguous()
        do = bf16(*qkv.shape[:2], heads * v.head_dim, scale=DOUT_SCALE)
        do[ids == 0] = 0
        rq, rk, rv = wa._rope_qk(qkv, cos, sin, heads)
        seg = segment_mask(ids)
        compare(f"fused_window_attention_bwd_tp{n}",
                lambda: wa.fused_window_attention_bwd(qkv, cos, sin, ids, heads, do),
                lambda: wa.fused_window_attention_bwd_torch(qkv, cos, sin, ids, heads, do), None,
                results, flops=10 * segment_pairs(ids) * heads * v.head_dim,
                moved=nbytes(qkv, cos, sin, ids, do, qkv),
                library_fn=lambda: sdpa_fwd_bwd(rq, rk, rv, do.view(*rq.shape), attn_mask=seg),
                case=f"{heads} of {v.num_heads} heads, W = {ids.shape[1]}")
        del qkv, do, rq, rk, rv, seg

        _, fn_, fw, fd, fpad = K6_FAMILY_CASES[0]
        for suffix in ("", "_d72"):
            if suffix:
                ids = torch.ones((fn_, fw), dtype=torch.int32, device=dev)
                ids[0, fw - fpad:] = 0
                q, k, vv = (bf16(fn_, fw, heads, fd) for _ in range(3))
                do = bf16(fn_, fw, heads, fd, scale=DOUT_SCALE)
                do[ids == 0] = 0
            else:
                ids, q, k, vv, do = frame_inputs(dev, gen, v, K2_FRAME_GRIDS[0], DOUT_SCALE)
                q, k, vv, do = (x[:, :, :heads].contiguous() for x in (q, k, vv, do))
            d = q.shape[-1]
            seg = segment_mask(ids)
            pairs = segment_pairs(ids) * heads * d
            out, lse = wa.window_attention_exact(q, k, vv, ids)
            ops = wa.bwd_operands(q, k, vv, ids, out, lse, do)
            ins = nbytes(*ops)
            lib = lambda: sdpa_fwd_bwd(q, k, vv, do, attn_mask=seg)  # noqa: E731
            case = f"{heads} of {v.num_heads} heads, head_dim {d}, W = {ids.shape[1]}"
            compare(f"window_attention_bwd_dq{suffix}_tp{n}",
                    lambda: wa.window_attention_bwd_dq(ops),
                    lambda: wa.window_attention_bwd_torch(q, k, vv, ids, do)[0], None, results,
                    flops=6 * pairs, moved=ins + nbytes(q), library_fn=lib, case=case)
            compare(f"window_attention_bwd_dkv{suffix}_tp{n}",
                    lambda: wa.window_attention_bwd_dkv(ops),
                    lambda: wa.window_attention_bwd_torch(q, k, vv, ids, do)[1:], None, results,
                    flops=8 * pairs, moved=ins + 2 * nbytes(q), library_fn=lib, case=case)
            del ids, q, k, vv, do, out, lse, ops, seg
    torch.cuda.empty_cache()


def ring_inputs(dev, seed: int, cfg):
    """25d's whole sequence: q, k, v and the output's gradient, (1,
    RING_TOKENS) rows of the 7B's 28/4 heads, drawn from ``seed`` (every
    rank draws the same)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 25)
    t = cfg.text

    def draw(h, scale=1.0):
        return (scale * torch.randn((1, RING_TOKENS, h, t.head_dim), generator=gen,
                                    device=dev)).to(torch.bfloat16)

    return (draw(t.num_attention_heads), draw(t.num_key_value_heads),
            draw(t.num_key_value_heads), draw(t.num_attention_heads, DOUT_SCALE))


def ring_kernel_cases(dev, seed: int, cfg, results) -> None:
    """25d's rows, in this process: the rank-1 step that meets rank 0's
    block (the query positions shifted by the block's first key position,
    0: every key visible): K3 exact, then K5 with the combined output and
    lse of both blocks, each against its plain version. And the rank-0 step
    that meets rank 1's block (shifted by -RING_TOKENS / 2): K3 exact gives
    each row, which sees no key, out 0 and lse NEG_INF, which the combine
    weighs by 0."""
    q, k, v, do = ring_inputs(dev, seed, cfg)
    h = RING_TOKENS // 2
    pos = torch.arange(RING_TOKENS, dtype=torch.int32, device=dev)[None]
    valid = torch.ones((1, h), dtype=torch.int32, device=dev)
    q1, do1, pos1 = q[:, h:].contiguous(), do[:, h:].contiguous(), pos[:, h:] - 0
    k0, v0 = k[:, :h].contiguous(), v[:, :h].contiguous()
    hq, d = q.shape[2], q.shape[3]
    pairs = h * h * hq * d
    out, lse = fa.flash_attention_gqa_exact(q, k, v, pos, torch.ones_like(pos))
    out1, lse1 = out[:, h:].contiguous(), lse[:, :, h:].contiguous()
    compare("flash_attention_gqa_exact_ring",
            lambda: fa.flash_attention_gqa_exact(q1, k0, v0, pos1, valid),
            lambda: fa.flash_attention_gqa_exact_torch(q1, k0, v0, pos1, valid), None, results,
            flops=4 * pairs, moved=nbytes(q1, k0, v0, pos1, valid, q1) + 4 * q1.numel() // d,
            library_fn=lambda: sdpa_masked(q1, k0, v0, None), plain_reps=RING_PLAIN_REPS,
            case=f"{hq}/{k.shape[2]} heads, {h} queries x the previous rank's {h} keys")
    ops = fa.bwd_operands(q1, k0, v0, pos1, valid, out1, lse1, do1)
    lib = lambda: sdpa_fwd_bwd(q1, k0, v0, do1)  # noqa: E731
    compare("flash_attention_gqa_bwd_dq_ring", lambda: fa.flash_attention_gqa_bwd_dq(ops),
            lambda: fa.flash_attention_gqa_bwd_torch(q1, k0, v0, pos1, valid, out1, lse1, do1)[0],
            None, results, flops=6 * pairs, moved=nbytes(*ops) + nbytes(q1), library_fn=lib,
            plain_reps=RING_PLAIN_REPS, case="the combined output and lse")
    compare("flash_attention_gqa_bwd_dkv_ring", lambda: fa.flash_attention_gqa_bwd_dkv(ops),
            lambda: fa.flash_attention_gqa_bwd_torch(q1, k0, v0, pos1, valid, out1, lse1,
                                                     do1)[1:],
            None, results, flops=8 * pairs, moved=nbytes(*ops) + nbytes(k0, v0), library_fn=lib,
            plain_reps=RING_PLAIN_REPS, case="the combined output and lse")
    o_m, lse_m = fa.flash_attention_gqa_exact(q[:, :h].contiguous(), k[:, h:].contiguous(),
                                              v[:, h:].contiguous(), pos[:, :h] - h, valid)
    masked_ok = bool((o_m == 0).all() and (lse_m == fa.NEG_INF).all())
    log("train_mesh", case="25d K3 exact on a block that masks every row", out_all_zero=masked_ok,
        lse=lse_m.flatten()[:1].item())
    if not masked_ok:
        raise RuntimeError("25d: K3 exact on a fully masked block gave out != 0 or lse != NEG_INF")
    del q, k, v, do, out, lse, ops, o_m, lse_m
    torch.cuda.empty_cache()


def mesh_world1_phase(params, cfg, proc, batch, seed: int) -> dict:
    """25a: the whole 7B on a one-rank NCCL mesh: a PEFT SFT step
    (``shard_params``, ``shard_batch``, ``make_lora_train_step(mesh=...)``,
    sft_main's mesh code) and a PEFT GSPO step (``GSPOTrainer(mesh=...)``,
    replayed rollouts, as in 18b) against the same steps without a mesh on
    the same batch: loss, gradient norm and updated adapters bit-equal.
    Returns the SFT step's launches."""
    from open_o3_video_tpu_torch.parallel import make_mesh, shard_params
    from open_o3_video_tpu_torch.train.sft import shard_batch

    mesh = make_mesh()
    for x in P.leaves(params):
        x.requires_grad_(False)
    tc = SFTConfig(learning_rate=MESH_TRAIN_LR)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        base = params if m is None else shard_params(params, m, cfg)
        adapters = init_adapters(params, LoraConfig(seed=seed), dtype=torch.bfloat16)
        opt = make_optimizer(tc)
        state = opt.init(adapter_leaves(adapters))
        step = make_lora_train_step(cfg, tc, opt, LoraConfig().scale, mesh=m)
        mesh.collectives.clear()
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, met = step(adapters, state, shard_batch(batch, m), base)
        torch.cuda.synchronize()
        runs[name] = {"loss": met["loss"].item(), "norm": met["grad_norm"].item(),
                      "adapters": adapters, "s": time.perf_counter() - t0,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "collectives": dict(mesh.collectives), "launches": dict(kernels.LAUNCHES)}
    a, b = runs["plain"], runs["mesh"]
    equal = (a["loss"] == b["loss"] and a["norm"] == b["norm"]
             and all(torch.equal(x, y) for x, y in zip(adapter_leaves(a["adapters"]),
                                                       adapter_leaves(b["adapters"]))))
    log("train_mesh", case="25a PEFT SFT step, one-rank NCCL mesh vs none", bit_equal=equal,
        loss=b["loss"], grad_norm=b["norm"], s_per_step={k: round(r["s"], 3) for k, r in runs.items()},
        peak_gib={k: round(r["peak_gib"], 3) for k, r in runs.items()},
        collectives_per_step=b["collectives"],
        launches={k: v for k, v in b["launches"].items() if v})
    if not equal:
        raise RuntimeError("25a: the one-rank mesh's PEFT SFT step differs from the mesh-less one")
    launches = b["launches"]
    del runs, a, b
    gc.collect()
    torch.cuda.empty_cache()

    sample = gspo_sample(proc, seed)
    gcfg = GSPOConfig(spec_rollout=True, max_completion_length=MESH_GSPO_TOKENS,
                      learning_rate=MESH_TRAIN_LR)
    trace = np.stack([reasoning_trace_tokens(MESH_GSPO_TOKENS + SPEC_TRACE_EXTRA, r,
                                             cfg.text.vocab_size, cfg.eos_token_id)
                      for r in range(gcfg.num_generations)])
    got = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        trainer = GSPOTrainer(params, None, cfg, gcfg, detokenize=CannedTraces(proc),
                              lora=LoraConfig(seed=seed), seed=seed, mesh=m)
        trainer.engine.spec_warmup, trainer.engine.spec_min_rate = 0, 0.0
        trainer.replay_tokens = trace
        mesh.collectives.clear()
        out = gspo_step(trainer, sample, 0, f"25a {name}", DECODER_TRAIN_KERNELS)
        got[name] = (out, [x.detach().clone() for x in adapter_leaves(trainer.adapters)],
                     dict(mesh.collectives))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    (pa, aa, _), (pb, ab, coll) = got["plain"], got["mesh"]
    equal = (pa["metrics"]["loss"] == pb["metrics"]["loss"] and pa["norm"] == pb["norm"]
             and pa["tokens"] == pb["tokens"] and all(torch.equal(x, y) for x, y in zip(aa, ab)))
    log("train_mesh", case="25a PEFT GSPO step, one-rank NCCL mesh vs none, replayed",
        bit_equal=equal, loss=pb["metrics"]["loss"], grad_norm=pb["norm"],
        s_per_step={"plain": pa["seconds"], "mesh": pb["seconds"]},
        peak_gib={"plain": pa["peak_gib"], "mesh": pb["peak_gib"]}, collectives_per_step=coll)
    if not equal:
        raise RuntimeError("25a: the one-rank mesh's PEFT GSPO step differs from the mesh-less one")
    return launches


def mesh_sft_batch(proc, cfg, seed: int) -> dict:
    """25c's global batch: two examples (sft_batch's, over two draws of
    frames), one row for each data rank at data 2."""
    singles = []
    for r in range(2):
        frames = np.random.default_rng(seed + 1 + r).integers(
            0, 256, size=(N_FRAMES, 3, FRAME_H, FRAME_W), dtype=np.uint8)
        messages = [
            {"role": "system", "content": [{"type": "text", "text": SFT_SYSTEM_PROMPT[SFT_TASK]}]},
            {"role": "user", "content": [{"type": "video", "video": "synthetic"},
                                         {"type": "text", "text": SFT_QUESTION}]},
            {"role": "assistant", "content": [{"type": "text", "text": SFT_ANSWER}]},
        ]
        singles.append(collate_sft_frames(messages, list(frames), FPS, proc, cfg))
    return pack_sft_batch(singles, cfg)


def _mesh_train_model(cfg, seed: int, dev):
    """25c's model: the 7B at full width, MESH_TRAIN_DEPTH deep, from --seed."""
    small = _cut_cfg(cfg, *MESH_TRAIN_DEPTH)
    return P.init(small, seed, dev), small


def _peft_step(params, cfg, batch, seed: int, mesh=None, impl="auto", dtype=torch.bfloat16):
    """One PEFT SFT step at MESH_TRAIN_LR: (loss, grad norm, adapters)."""
    from open_o3_video_tpu_torch.train.sft import shard_batch

    tc = SFTConfig(learning_rate=MESH_TRAIN_LR)
    adapters = init_adapters(params, LoraConfig(seed=seed), dtype=torch.bfloat16)
    if dtype != torch.bfloat16:
        adapters = {"layers": [{n: {k: x.detach().to(dtype).requires_grad_()
                                    for k, x in ab.items()} for n, ab in layer.items()}
                               for layer in adapters["layers"]]}
    opt = make_optimizer(tc)
    state = opt.init(adapter_leaves(adapters))
    _, _, m = make_lora_train_step(cfg, tc, opt, LoraConfig().scale, attn_impl=impl, mesh=mesh)(
        adapters, state, shard_batch(batch, mesh), params)
    return m["loss"].item(), m["grad_norm"].item(), adapters


def train_mesh_rank_main(rank: int, world: int, store: str, out_path: str, seed: int) -> None:
    """25c-25e, one of two gloo ranks on the one card: the ring at context
    2 (25d), the pipeline (25e), then the cut 7B's PEFT SFT steps at tensor
    2 and at data 2, a full fine-tune step at tensor 2, and a PEFT GSPO
    step at data 2 with rows sharded (25c). Each part's launches are
    counted from 0."""
    import torch.distributed as dist

    from open_o3_video_tpu_torch.ops.ring_attention import ring_attention
    from open_o3_video_tpu_torch.parallel import distributed, make_mesh, shard_params
    from open_o3_video_tpu_torch.parallel.pipeline import dryrun_pipeline_step

    distributed.initialize(f"file://{store}", world, rank, device="cpu")  # gloo
    dev = torch.device("cuda")
    cfg = Qwen25VLConfig()
    res = {}

    def timed(fn):
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"s": round(time.perf_counter() - t0, 3), "launches": dict(kernels.LAUNCHES),
                     "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}

    # 25d: this rank's block of the ring, then every rank's gathered
    ring = make_mesh(data=1, fsdp=1, context=world, device_type="cuda")
    q, k, v, do = ring_inputs(dev, seed, cfg)
    per = RING_TOKENS // world
    rows = slice(rank * per, (rank + 1) * per)
    pos = torch.arange(RING_TOKENS, device=dev)[None]
    ql, kl, vl = (x[:, rows].contiguous().requires_grad_() for x in (q, k, v))

    def ring_step():
        out = ring_attention(ql, kl, vl, pos[:, rows], pos[:, rows], None,
                             ring.groups["context"])
        out.backward(do[:, rows])
        return out

    out, res["ring"] = timed(ring_step)
    got = [ring.all_gather(x.detach(), "context", dim=1) for x in (out, ql.grad, kl.grad, vl.grad)]
    if rank == 0:
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        whole = torch.ones((1, RING_TOKENS), dtype=torch.int32, device=dev)
        ref = fa.FlashAttentionGQA.apply(qq, kk, vv, pos, whole, "auto")
        ref.backward(do)
        res["ring_agreement"] = {name: agreement(a, b, None) for name, a, b in zip(
            ("out", "dq", "dk", "dv"), got, (ref, qq.grad, kk.grad, vv.grad))}
    del q, k, v, do, ql, kl, vl, out, got
    torch.cuda.empty_cache()

    # 25e: two stages of the 7B's decoder at full width
    pcfg = _cut_cfg(cfg, 1, 2 * world)
    res["pipe"], res["pipe_run"] = timed(lambda: dryrun_pipeline_step(
        world, 2, cfg=pcfg, device="cuda", seed=seed, batch_rows=PIPE_ROWS, seq_len=PIPE_TOKENS,
        check_sequential=True))
    torch.cuda.empty_cache()

    # 25c
    params, small = _mesh_train_model(cfg, seed, dev)
    batch = mesh_sft_batch(O3VideoProcessor(), cfg, seed)
    for name, shape in (("tp2", (1, 1, world)), ("dp2", (world, 1, 1))):
        mesh = make_mesh(*shape, device_type="cuda")
        sharded = shard_params(params, mesh, small)
        (loss, norm, adapters), res[f"sft_{name}"] = timed(
            lambda: _peft_step(sharded, small, batch, seed, mesh))
        res[f"sft_{name}"].update(loss=loss, norm=norm, collectives=dict(mesh.collectives),
                                  adapters=[x.detach().cpu() for x in adapter_leaves(adapters)])
        del sharded, adapters
        gc.collect()
        torch.cuda.empty_cache()
    mesh = make_mesh(1, 1, world, device_type="cuda")
    full = P.trainable(shard_params(params, mesh, small))
    tc = SFTConfig(learning_rate=MESH_TRAIN_LR)
    opt = make_optimizer(tc)
    state = opt.init(full)
    from open_o3_video_tpu_torch.train.sft import shard_batch

    (_, _, m), res["full_tp2"] = timed(lambda: make_train_step(small, tc, opt, mesh=mesh)(
        full, state, shard_batch(batch, mesh)))
    res["full_tp2"].update(loss=m["loss"].item(), norm=m["grad_norm"].item())
    del full, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    for x in P.leaves(params):
        x.requires_grad_(False)
    proc = O3VideoProcessor()
    dp = make_mesh(world, 1, 1, device_type="cuda")
    gcfg = GSPOConfig(spec_rollout=True, max_completion_length=MESH_GSPO_TOKENS,
                      learning_rate=MESH_TRAIN_LR)
    trainer = GSPOTrainer(params, None, small, gcfg, detokenize=CannedTraces(proc),
                          lora=LoraConfig(seed=seed), seed=seed, mesh=dp)
    trainer.engine.spec_warmup, trainer.engine.spec_min_rate = 0, 0.0
    trainer.engine.decode_graph = False  # a gloo collective cannot be captured (24c)
    trainer.replay_tokens = np.stack([
        reasoning_trace_tokens(MESH_GSPO_TOKENS + SPEC_TRACE_EXTRA, r, cfg.text.vocab_size,
                               cfg.eos_token_id) for r in range(gcfg.num_generations)])
    met, res["gspo_dp2"] = timed(lambda: trainer.step(gspo_sample(proc, seed), global_step=0,
                                                      max_steps=GSPO_MAX_STEPS))
    res["gspo_dp2"].update(metrics=met, layout=trainer.engine.last_rollout_layout,
                           stages={k: v["total_s"] for k, v in trainer.timer.report().items()})
    torch.save(res, out_path)
    dist.destroy_process_group()


def train_mesh_two_ranks(cfg, seed: int, dev) -> dict:
    """25c-25e: the references first (the cut 7B's PEFT SFT step in bf16
    and in float32 on one rank), then two gloo ranks on the card (NCCL
    refuses two ranks on one device), each a process of this script; their
    results against the bounds stated above. Returns rank 0's results."""
    import tempfile

    params, small = _mesh_train_model(cfg, seed, dev)
    batch = mesh_sft_batch(O3VideoProcessor(), cfg, seed)
    for x in P.leaves(params):
        x.requires_grad_(False)
    ref = {"bf16": _peft_step(params, small, batch, seed)}
    p32 = _cast(params, torch.float32)
    ref["f32"] = _peft_step(p32, dataclasses.replace(small, dtype=torch.float32), batch, seed,
                            impl="torch", dtype=torch.float32)
    del params, p32
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--train-mesh-rank",
                                   str(r), "--seed", str(seed), "--mesh-store", store,
                                   "--mesh-out", outs[r]]) for r in range(2)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"25c-e: a rank exited {codes}")
        got = [torch.load(o, weights_only=False) for o in outs]

    ring = got[0]["ring_agreement"]
    log("train_mesh", case=f"25d ring, context 2 over {RING_TOKENS} tokens, two gloo ranks",
        agreement={k: {"max_abs_err": a["max_abs_err"], "bound": a["bound"], "rel_l2": a["rel_l2"]}
                   for k, a in ring.items()}, max_rel_l2=KERNEL_REL_L2,
        seconds=[g["ring"]["s"] for g in got], peak_gib=[g["ring"]["peak_gib"] for g in got],
        launches={k: v for k, v in got[0]["ring"]["launches"].items() if v})
    if not all(a["ok"] for a in ring.values()):
        raise RuntimeError(f"25d: the ring is off the single-device K3 exact and K5: {ring}")

    pipe = [g["pipe"] for g in got]
    log("train_mesh", case=f"25e pipeline, 2 stages x 2 microbatches, {PIPE_ROWS} x {PIPE_TOKENS}",
        results=pipe, seconds=[g["pipe_run"]["s"] for g in got],
        launches={k: v for k, v in got[0]["pipe_run"]["launches"].items() if v})
    for p in pipe:
        if not (p["hidden_err"] <= KERNEL_ATOL * p["hidden_scale"]
                and p["grad_err"] <= KERNEL_ATOL * max(p["grad_scale"], 1e-30)):
            raise RuntimeError(f"25e: the pipelined step is off the sequential one: {p}")

    f32_loss, f32_norm, f32_ad = ref["f32"]
    one_rel = abs(ref["bf16"][1] - f32_norm) / f32_norm
    norm_bound = max(SLICE_REL_RATIO * one_rel, MESH_NORM_FLOOR)
    ad_bound = adapter_bound(ref["bf16"][2])
    one_gap = adapter_gap(ref["bf16"][2], f32_ad)
    for name in ("tp2", "dp2"):
        r = got[0][f"sft_{name}"]
        rel = abs(r["norm"] - f32_norm) / f32_norm
        gap = max((a.float() - b.detach().float().cpu()).abs().max().item()
                  for a, b in zip(r["adapters"], adapter_leaves(f32_ad)))
        same = all(torch.equal(a, b) for a, b in zip(r["adapters"], got[1][f"sft_{name}"]["adapters"]))
        log("train_mesh", case=f"25c PEFT SFT step at {name}, two gloo ranks, depth "
            f"{MESH_TRAIN_DEPTH}", loss=r["loss"], loss_f32=f32_loss, grad_norm=r["norm"],
            grad_norm_f32=f32_norm, norm_rel=rel, norm_bound=norm_bound, one_rank_norm_rel=one_rel,
            adapters_max_diff=gap, adapters_bound=ad_bound, one_rank_adapters_max_diff=one_gap,
            ranks_equal=same, s_per_step=r["s"], peak_gib=r["peak_gib"],
            collectives=r["collectives"], launches={k: v for k, v in r["launches"].items() if v})
        if not (rel <= norm_bound and gap <= ad_bound and same):
            raise RuntimeError(f"25c {name}: norm {rel} (bound {norm_bound}), adapters {gap} "
                               f"(bound {ad_bound}), ranks equal {same}")
    full = got[0]["full_tp2"]
    log("train_mesh", case="25c full fine-tune step at tp2", loss=full["loss"],
        grad_norm=full["norm"], s_per_step=full["s"], peak_gib=full["peak_gib"],
        launches={k: v for k, v in full["launches"].items() if v})
    if not (np.isfinite(full["loss"]) and np.isfinite(full["norm"]) and full["norm"] > 0):
        raise RuntimeError(f"25c: the full fine-tune step at tp2 gave {full}")
    g = [x["gspo_dp2"] for x in got]
    log("train_mesh", case="25c PEFT GSPO step at dp2, replayed", layout=g[0]["layout"],
        loss=[x["metrics"]["loss"] for x in g], kl=[x["metrics"]["kl"] for x in g],
        s_per_step=[x["s"] for x in g], stages=g[0]["stages"], peak_gib=[x["peak_gib"] for x in g],
        launches={k: v for k, v in g[0]["launches"].items() if v})
    if (g[0]["layout"] != "rows_sharded(data=2)" or g[0]["metrics"] != g[1]["metrics"]
            or not np.isfinite(g[0]["metrics"]["loss"])):
        raise RuntimeError(f"25c GSPO: layout {g[0]['layout']}, metrics {g[0]['metrics']} vs "
                           f"{g[1]['metrics']}")
    return got[0]


def train_mesh_phase(dev, seed: int, results: dict) -> dict:
    """Phase 25: 25a the 7B's PEFT SFT and GSPO steps on a one-rank NCCL
    mesh, bit-equal to the mesh-less steps; 25b K5 and K6 at shard shapes;
    the ring's block calls; 25c-e two gloo ranks on the card (training at
    tensor 2 and data 2, the ring at context 2, the pipeline). Returns the
    launches of its rows on their main paths (25c's at tensor 2, 25d's
    ring; tensor 4 needs four cards)."""
    from open_o3_video_tpu_torch.parallel import distributed

    import torch.distributed as dist

    t_phase = time.perf_counter()
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ["MASTER_PORT"] = str(_free_port())
    distributed.initialize(f"localhost:{os.environ['MASTER_PORT']}", 1, 0, device="cuda")
    cfg = Qwen25VLConfig()
    proc = O3VideoProcessor()
    batch = sft_batch(proc, cfg, seed)
    params = P.init(cfg, seed, dev)
    world1 = mesh_world1_phase(params, cfg, proc, batch, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    for name in DECODER_TRAIN_KERNELS:
        if not world1.get(name):
            raise RuntimeError(f"25a: {name} never launched on the mesh: {world1}")
    t_a = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 25)
    train_mesh_kernel_cases(dev, gen, cfg, batch, results)
    ring_kernel_cases(dev, seed, cfg, results)
    t_b = time.perf_counter()
    got = train_mesh_two_ranks(cfg, seed, dev)
    log("train_mesh", phase_seconds={"25a": round(t_a - t_phase, 3), "25b": round(t_b - t_a, 3),
                                     "25c-e": round(time.perf_counter() - t_b, 3),
                                     "25": round(time.perf_counter() - t_phase, 3)})
    launches = {name: 0 for name in TRAIN_MESH_CASES}  # tensor 4 needs four cards
    tp2 = {**got["sft_tp2"]["launches"]}
    for k, v in got["full_tp2"]["launches"].items():
        tp2[k] = tp2.get(k, 0) + v
    launches.update({f"{name}_tp2": tp2.get(name, 0) for name in
                     ("flash_attention_gqa_bwd_dq", "flash_attention_gqa_bwd_dkv",
                      "fused_window_attention_bwd", "window_attention_bwd_dq",
                      "window_attention_bwd_dkv")})
    ring = got["ring"]["launches"]
    launches.update({"flash_attention_gqa_exact_ring": ring.get("flash_attention_gqa_exact", 0),
                     "flash_attention_gqa_bwd_dq_ring": ring.get("flash_attention_gqa_bwd_dq", 0),
                     "flash_attention_gqa_bwd_dkv_ring": ring.get("flash_attention_gqa_bwd_dkv",
                                                                  0)})
    for name in ("flash_attention_gqa_exact_ring", "flash_attention_gqa_bwd_dq_ring",
                 "flash_attention_gqa_bwd_dq_tp2", "fused_window_attention_bwd_tp2"):
        if not launches[name]:
            raise RuntimeError(f"25: {name} never launched on its mesh path: {launches}")
    return launches



# ---------------------------------------------------------------- phase 26
# Kimi-VL-A3B (the longvideo.kimi-vl-a3b cell's shapes): its two MLA kernels
# and K2 at MoonViT's frames against their plain versions, then the family
# through InferenceEngine.generate.
KIMI_CASES = {
    "mla_decode": ("open_o3_video_tpu_torch/csrc/mla_attention.cu",
                   "none: the JAX package has no latent attention"),
    "mla_prefill": ("open_o3_video_tpu_torch/csrc/mla_attention.cu",
                    "none: the JAX package has no latent attention"),
    "window_attention_d72_w1008": TPU_KERNELS["window_attention"],
}
# The cell's decode step (8 rows over ~18.7k written latent columns), its
# prefix block (the shared video prefix, one row) and its suffix admission
# (8 rows of ~100 question tokens after the prefix, the shorter rows
# left-padded inside the suffix); MoonViT's frames of 24 x 42 patches, a
# call's 64 at once.
KIMI_DECODE = (8, 18700)
KIMI_PREFIX = 18262
KIMI_SUFFIX = (8, 96)
KIMI_FRAMES, KIMI_W = 64, 1008
# The generate run: the cell's widths, the depth cut (a dense layer and two
# routed; 4 tower blocks), 8 frames of 360x640 resized on the card to
# 336x588, three questions sharing the video prefix, 16 greedy tokens.
KIMI_RUN_LAYERS, KIMI_RUN_BLOCKS, KIMI_RUN_FRAMES, KIMI_RUN_TOKENS = 3, 4, 8, 16
KIMI_HEADS, KIMI_SCALE = 16, 192 ** -0.5


def _mla_decode_flops_bytes(q_lat, q_pe, cache, pos, valid, out) -> tuple[float, int]:
    """The absorbed decode's operations (2 x (576 + 512) a visible (row,
    head, key)) and bytes (the live latent columns once, q, positions,
    validity and the output)."""
    pairs = causal_pairs(pos, valid) * q_lat.shape[2]
    cols = causal_pairs(pos.max(1, keepdim=True).values, valid)  # each batch row's, once
    live = cols * cache.shape[-1] * cache.element_size()
    return 2.0 * pairs * (cache.shape[-1] + q_lat.shape[-1]), int(
        live + nbytes(q_lat, q_pe, pos, valid, out))


def _mla_prefill_inputs(dev, gen, B, S, T, holes: bool):
    """Random expanded inputs at the cell's widths: q (B, S, 16, 192) split
    into its views, the expansion kv (B, T, 16, 256) split into k_nope and
    v, k_pe a view of a (B, T, 576) latent row; queries at the last S
    positions; with ``holes`` a left pad of each row's suffix."""
    q = torch.randn((B, S, KIMI_HEADS, 192), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, T, KIMI_HEADS, 256), generator=gen, device=dev).to(torch.bfloat16)
    lat = torch.randn((B, T, 576), generator=gen, device=dev).to(torch.bfloat16)
    pos = (torch.arange(S, device=dev) + T - S)[None].repeat(B, 1)
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    if holes:
        for b in range(1, B):  # row b's question is 8 b tokens shorter: its first columns are pad
            valid[b, T - S:T - S + 8 * b] = False
            pos[b, :8 * b] = -1
    return (q[..., :128], q[..., 128:].contiguous(), kv[..., :128], lat[..., 512:], kv[..., 128:],
            pos, valid)


def _library(fn):
    """``fn`` where one call of it runs, else None (a yardstick only: no
    backend of PyTorch may take the shapes)."""
    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, torch.OutOfMemoryError) as e:
        log("kernels", library_error=str(e)[:200])
        return None


def _sdpa_expanded(qn, qp, kn, kp, v):
    """One PyTorch call for the expanded prefill's time: causal SDPA over q
    = [q_nope | q_pe] and k = [k_nope | k_pe] expanded over the heads (the
    library's yardstick only; its mask is the square causal one)."""
    H = qn.shape[2]
    q = torch.cat([qn, qp], -1).transpose(1, 2)
    k = torch.cat([kn, kp[:, :, None].expand(-1, -1, H, -1)], -1).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(q, k, v.transpose(1, 2), is_causal=True,
                                                  scale=KIMI_SCALE)


def kimi_kernel_cases(dev, gen, results) -> None:
    """26a: the MLA decode at the cell's step (8 rows x 18700 columns, a
    tenth invalid, row 0 at a third of the buffer) and at 1 x 8 rows x
    40000 (eight 16-row blocks), with the planted faults "rope part left
    out" and "scale of head_dim 128" (both must fail the bound); the MLA
    prefill at the prefix block (1 x 18262 causal rows; 256 of them
    compared, the plain version at all of them would need ~20 GB of
    scores; the whole block timed beside its bound and causal SDPA) with
    the planted fault "k_pe left out", and at the suffix admission (8 x 96
    rows at the end of 18358 columns, left-padded); K2 at MoonViT's 64
    frames of W = 1008, head_dim 72, with its bound and SDPA."""
    B, T = KIMI_DECODE
    for b_, s_, t_ in ((B, 1, T), (1, 8, 40000)):
        cache = torch.randn((b_, t_, 576), generator=gen, device=dev).to(torch.bfloat16)
        q_lat = torch.randn((b_, s_, KIMI_HEADS, 512), generator=gen, device=dev).to(torch.bfloat16)
        q_pe = torch.randn((b_, s_, KIMI_HEADS, 64), generator=gen, device=dev).to(torch.bfloat16)
        valid = torch.rand((b_, t_), generator=gen, device=dev) > 0.1
        pos = (torch.arange(s_, device=dev) + t_ - s_)[None].repeat(b_, 1)
        pos[0, 0] = t_ // 3
        args = (q_lat, q_pe, cache, pos, valid, KIMI_SCALE)
        out = mla.mla_decode(*args)
        flops, moved = _mla_decode_flops_bytes(q_lat, q_pe, cache, pos, valid, out)
        qs = torch.cat([q_lat, q_pe], -1).transpose(1, 2)
        kt = cache[:, None]
        mask = causal_mask(pos, valid)
        ref = compare("mla_decode", lambda: mla.mla_decode(*args),
                      lambda: mla.mla_decode_torch(*args), None, results,
                      case=f"{b_} x {s_} rows x {t_} columns", flops=flops, moved=moved,
                      library_fn=_library(lambda: F.scaled_dot_product_attention(
                          qs, kt, kt[..., :512], attn_mask=mask, scale=KIMI_SCALE,
                          enable_gqa=True)))
        if s_ == 1:
            planted("mla_decode", "rope part left out",
                    mla.mla_decode(q_lat, torch.zeros_like(q_pe), cache, pos, valid, KIMI_SCALE),
                    ref, None)
            planted("mla_decode", "scale of head_dim 128",
                    mla.mla_decode(q_lat, q_pe, cache, pos, valid, 128 ** -0.5), ref, None)
        del cache, q_lat, q_pe, qs, kt, mask
        torch.cuda.empty_cache()

    qn, qp, kn, kp, v, pos, valid = _mla_prefill_inputs(dev, gen, 1, KIMI_PREFIX, KIMI_PREFIX,
                                                        False)
    rows = torch.cat([torch.arange(0, KIMI_PREFIX, 128, device=dev)[:128],
                      torch.arange(KIMI_PREFIX - 128, KIMI_PREFIX, device=dev)])
    sub = (qn[:, rows], qp[:, rows].contiguous())
    ps = pos[:, rows].contiguous()
    flops = 2 * (192 + 128) * causal_pairs(ps, valid) * KIMI_HEADS
    ref = compare("mla_prefill", lambda: mla.mla_prefill_attention(*sub, kn, kp, v, ps, valid,
                                                                   KIMI_SCALE),
                  lambda: mla.mla_prefill_attention_torch(*sub, kn, kp, v, ps, valid, KIMI_SCALE),
                  None, results, case=f"prefix block, {len(rows)} of its {KIMI_PREFIX} rows",
                  flops=flops, moved=nbytes(*sub, kn, kp, v, ps, valid, sub[0]))
    planted("mla_prefill", "k_pe left out",
            mla.mla_prefill_attention(*sub, kn, torch.zeros_like(kp), v, ps, valid, KIMI_SCALE),
            ref, None)
    full = lambda: mla.mla_prefill_attention(qn, qp, kn, kp, v, pos, valid, KIMI_SCALE)
    ms = statistics.median(time_ms(full, reps=10))
    flops = 2 * (192 + 128) * causal_pairs(pos, valid) * KIMI_HEADS
    b_ms, b_by = bound_ms(flops, nbytes(qn, qp, kn, kp, v, pos, valid, v))
    lib_fn = _library(_sdpa_expanded(qn, qp, kn, kp, v))  # the port never calls it
    lib = None if lib_fn is None else statistics.median(time_ms(lib_fn, reps=10))
    log("kernels", name="mla_prefill", case="prefix block, all rows",
        shape=(1, KIMI_PREFIX, KIMI_HEADS, 128), ms=round(ms, 4), bound_ms=round(b_ms, 4),
        bound_by=b_by, library_ms=None if lib is None else round(lib, 4),
        tflops=round(flops / ms / 1e9, 1))
    results["mla_prefill"].update(ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                                  plain_ms=None)
    del qn, qp, kn, kp, v, sub
    torch.cuda.empty_cache()

    Bs, S = KIMI_SUFFIX
    qn, qp, kn, kp, v, pos, valid = _mla_prefill_inputs(dev, gen, Bs, S, KIMI_PREFIX + S, True)
    compare("mla_prefill", lambda: mla.mla_prefill_attention(qn, qp, kn, kp, v, pos, valid,
                                                             KIMI_SCALE),
            lambda: mla.mla_prefill_attention_torch(qn, qp, kn, kp, v, pos, valid, KIMI_SCALE),
            pos >= 0, results, case=f"suffix admission, {Bs} x {S} after {KIMI_PREFIX}",
            flops=2 * (192 + 128) * causal_pairs(pos, valid) * KIMI_HEADS,
            moved=nbytes(qn, qp, kn, kp, v, pos, valid, qn))
    del qn, qp, kn, kp, v
    torch.cuda.empty_cache()

    ids = torch.ones((KIMI_FRAMES, KIMI_W), dtype=torch.int32, device=dev)
    q, k, v = (torch.randn((KIMI_FRAMES, KIMI_W, KIMI_HEADS, 72), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    seg = segment_mask(ids)
    compare("window_attention_d72_w1008", lambda: wa.window_attention(q, k, v, ids),
            lambda: wa.window_attention_torch(q, k, v, ids), None, results,
            flops=4 * segment_pairs(ids) * KIMI_HEADS * 72, moved=nbytes(q, k, v, ids, q),
            library_fn=lambda: sdpa_masked(q, k, v, seg),
            case=f"MoonViT, {KIMI_FRAMES} frames, head_dim 72, W = {KIMI_W}")
    del q, k, v, seg
    torch.cuda.empty_cache()


def kimi_requests(cfg, seed: int) -> list[Request]:
    """26b's requests: one video of KIMI_RUN_FRAMES uint8 frames (360x640,
    resized on the card to 336x588: 24 x 42 patches, 252 placeholders a
    frame) and three questions of different lengths after it."""
    frames = np.random.default_rng(seed).integers(
        0, 256, size=(KIMI_RUN_FRAMES, 3, 360, 640), dtype=np.uint8)
    prefix = list(b"system: answer about the video. user: ")
    prefix += [cfg.image_token_id] * (KIMI_RUN_FRAMES * 252)
    grid = np.array([(KIMI_RUN_FRAMES, 24, 42)])
    return [Request(input_ids=prefix + list(q.encode()) + [cfg.bos_token_id], frames=frames,
                    resize_hw=(336, 588), grid_thw=grid, vision_token_id=cfg.image_token_id)
            for q in (*QUESTIONS, "Where is the ball at 3 seconds?")]


def kimi_phase(dev, seed: int, results: dict) -> dict:
    """Phase 26: 26a the kernel cases; 26b Kimi-VL at the cell's widths,
    cut to KIMI_RUN_LAYERS decoder layers and KIMI_RUN_BLOCKS tower blocks,
    through InferenceEngine.generate (graphed) with the launch counts set
    to 0 just before and read just after: one tower pass through K2
    (blocks x passes launches), the prefix block and the suffix admission
    through the MLA prefill (layers x forwards), every decode step through
    the MLA decode (layers x the steps that ran, replays counted); then the
    same requests decoded eagerly must give the same tokens (each engine
    served a 2-token call on another video first, so neither run carries
    first-use costs). Returns the
    run's launches of the phase's kernel rows."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kimi_kernel_cases(dev, gen, results)
    full = kimi_vl.KimiVLConfig()
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, depth=KIMI_RUN_BLOCKS),
        text=dataclasses.replace(full.text, num_hidden_layers=KIMI_RUN_LAYERS))
    params = kimi_vl.params.init(cfg, seed, dev)
    reqs = kimi_requests(cfg, seed)
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=KIMI_RUN_TOKENS)
    engine = InferenceEngine(params, cfg)
    # first-use costs, on another video (the measured call shares nothing with it)
    engine.generate(kimi_requests(cfg, seed + 1), dataclasses.replace(greedy, max_tokens=2))
    torch.cuda.reset_peak_memory_stats()
    outs, run = decode_run(engine, lambda: engine.generate(reqs, greedy))
    got = dict(kernels.LAUNCHES)
    ran = run["steps"] + run["wasted"]
    sched = run["scheduler"]
    forwards = sched["prefills"]
    want = {"mla_decode": KIMI_RUN_LAYERS * ran, "mla_prefill": KIMI_RUN_LAYERS * forwards,
            "window_attention": KIMI_RUN_BLOCKS * sched["tower_passes"]}
    log("kimi", run="generate", prompt_tokens=[o["num_prompt_tokens"] for o in outs],
        new_tokens=[len(o["token_ids"]) for o in outs], launches=got, want=want,
        steps=run["steps"], wasted=run["wasted"], prefills=forwards,
        prefix_blocks=sched["prefix_blocks"], tower_passes=sched["tower_passes"],
        vision_ms=round(1e3 * run["vision_s"], 3), prefill_ms=round(1e3 * run["prefill_s"], 3),
        decode_ms_per_token=run["ms_per_token"],
        peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    if any(got.get(k, 0) != n or n == 0 for k, n in want.items()):
        raise RuntimeError(f"26b: launches {got}, want {want}")
    norm_launches("Kimi-VL", cfg, run, "kimi")
    if sched["prefix_blocks"] < 1:
        raise RuntimeError("26b: the shared video prefix made no prefix block")
    eager = InferenceEngine(params, cfg, decode_graph=False)
    eager.generate(kimi_requests(cfg, seed + 1), dataclasses.replace(greedy, max_tokens=2))
    again, eager_run = decode_run(eager, lambda: eager.generate(reqs, greedy))
    decode_pair("Kimi-VL", run, eager_run, [o["token_ids"] for o in outs],
                [o["token_ids"] for o in again])
    del engine, eager, params
    gc.collect()
    torch.cuda.empty_cache()
    log("kimi", phases_seconds=round(time.perf_counter() - t0, 3))
    return {"mla_decode": got["mla_decode"], "mla_prefill": got["mla_prefill"],
            "window_attention_d72_w1008": got["window_attention"]}



# ---------------------------------------------------------------- phase 27
# RMSNorm at the cells' shapes: (case, rows, width, row stride).
NORM_CASES = (
    ("the 30B's and Kimi's decode step", 8, 2048, 2048),
    ("the 7B's decode step", 8, 3584, 3584),
    ("the 30B's q-norm at decode (8 rows x 32 heads)", 256, 128, 128),
    ("Kimi's kv_norm at decode (ckv[..., :512])", 8, 512, 576),
    ("a vstar tower pass (16 frames)", 16384, 1280, 1280),
    ("the long-context tower (64 frames of 4968 patches)", 317952, 1280, 1280),
)
NORM_GRAPH_CALLS = 64  # calls in the graph that times a decode-shaped norm
NORM_RUN_BLOCKS, NORM_RUN_LAYERS = 8, 4  # 27b's cut of the 7B (block 7 attends whole frames)
NORM_KERNELS = {"rms_norm": ("open_o3_video_tpu_torch/csrc/rms_norm.cu",
                             "none: the JAX package's rms_norm is plain jnp, fused by XLA")}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most bf16 ulps between a and b (ordered bit patterns)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max().item())


def device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` runs, read from the profiler's raw
    events as the benchmark's trace reads them (``portbench/lib/trace.py``):
    the events on the device, copies and sets left out."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset")))


def graph_call_ms(fn, calls: int = NORM_GRAPH_CALLS) -> float:
    """A call's share of a replayed CUDA graph of ``calls`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = statistics.median(time_ms(graph.replay, reps=10))
    del graph
    return ms / calls


def norm_phase(dev, seed: int, results: dict) -> None:
    """Phase 27a: each NORM_CASES case under inference mode (the kernel's
    rule), the kernel, the plain chain and F.rms_norm on the same bf16 rows
    and weight: the kernel's every output within one bf16 ulp of the
    chain's, one LAUNCHES count and exactly one device kernel a call (the
    chain's and F.rms_norm's device kernels counted beside it), F.rms_norm's
    most ulps from the chain, times in turns (plain, kernel, kernel, plain)
    with the byte bound (the rows read once, the output written once, the
    weight) and F.rms_norm's time, and at up to 256 rows each one's share
    of a replayed graph of NORM_GRAPH_CALLS calls. The faults are raised
    together after the last case."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    faults = []
    with torch.inference_mode():
        for case, rows, d, stride in NORM_CASES:
            buf = torch.randn(rows, stride, device=dev, generator=gen).bfloat16()
            x = buf[:, :d]
            w = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).bfloat16()
            eps = 1e-6

            def kernel_fn():
                return rn.rms_norm(x, w, eps)

            def plain_fn():
                return rn.rms_norm_torch(x, w, eps)

            def library_fn():
                return F.rms_norm(x, (d,), w, eps)

            before = kernels.LAUNCHES["rms_norm"]
            out, ref, lib = kernel_fn(), plain_fn(), library_fn()
            torch.cuda.synchronize()
            if kernels.LAUNCHES["rms_norm"] != before + 1:
                faults.append(f"{case}: the kernel did not launch once a call")
            ulps, lib_ulps = bf16_ulps(out, ref), bf16_ulps(lib, ref)
            if ulps > 1 or bool((out.isnan() & ~ref.isnan()).any()):
                faults.append(f"{case}: {ulps} bf16 ulps from the plain version")
            del out, ref, lib
            n_kernel = device_kernels(kernel_fn)
            n_plain, n_lib = device_kernels(plain_fn), device_kernels(library_fn)
            if n_kernel != 1:
                faults.append(f"{case}: {n_kernel} device kernels a call (profiler)")
            p1, k1, k2, p2 = (time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
            ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
            lib_ms = statistics.median(time_ms(library_fn))
            b_ms, b_by = bound_ms(0.0, 2 * 2 * rows * d + nbytes(w))
            graph = ({"graph_ms": round(graph_call_ms(kernel_fn), 5),
                      "plain_graph_ms": round(graph_call_ms(plain_fn), 5),
                      "library_graph_ms": round(graph_call_ms(library_fn), 5)}
                     if rows <= 256 else {})
            log("norm", case=case, shape=(rows, d), row_stride=stride, max_ulps=ulps,
                ms=round(ms, 5), plain_ms=round(plain_ms, 5), bound_ms=round(b_ms, 5),
                bound_by=b_by, library_ms=round(lib_ms, 5), library_max_ulps=lib_ulps,
                device_kernels=n_kernel, plain_device_kernels=n_plain,
                library_device_kernels=n_lib, **graph)
            if "rms_norm" not in results:
                results["rms_norm"] = {"max_abs_err": None, "max_ulps": ulps, "ms": ms,
                                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                       "library_ms": lib_ms, **graph}
            del buf, x
            torch.cuda.empty_cache()
    log("norm", phases_seconds=round(time.perf_counter() - t0, 3))
    if faults:
        raise RuntimeError("27a: " + "; ".join(faults))


def norm_run_phase(dev, seed: int) -> int:
    """Phase 27b (--only norm): Qwen2.5-VL-7B at full width cut to
    NORM_RUN_BLOCKS tower blocks and NORM_RUN_LAYERS decoder layers, phase
    4's requests and sampling through InferenceEngine.generate
    (``slice_phase``): the RMSNorm kernel's launches held to the main
    path's (``norm_launches``). Returns them."""
    cfg = _cut_cfg(Qwen25VLConfig(), NORM_RUN_BLOCKS, NORM_RUN_LAYERS)
    params = P.init(cfg, seed, dev)
    engine = InferenceEngine(params, cfg)
    sampling = SamplingParams(temperature=0.7, top_p=0.001, repetition_penalty=1.05,
                              max_tokens=MAX_TOKENS, seed=seed)
    _, _, run = slice_phase(engine, make_requests(O3VideoProcessor(), cfg, seed), sampling,
                            names=SLICE_KERNELS + ("rms_norm",))
    got = norm_launches("Qwen2.5-VL-7B, cut", cfg, run, "norm")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return got


def norm_process(seed: int, results: dict) -> None:
    """Phase 27 in a process of its own (``--only norm``, 27a and 27b): a
    profiler session late in this process read 0 device kernels a call
    where the same session in a fresh process read the kernel's 1 and the
    chain's 9 (an H100 with PyTorch 2.11). Its phase lines are printed
    here (its kernels and ok lines are not: this script prints its own
    last), and its kernel row joins ``results``."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                           "--only", "norm"], capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    print("\n".join(x for x in lines if not x.startswith(('{"kernels"', '{"ok"'))), flush=True)
    print(proc.stderr[-4000:], end="", file=sys.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"27: chip_smoke.py --only norm exited with {proc.returncode}")
    line = next(x for x in lines if x.startswith('{"kernels"'))
    row = json.loads(line)["kernels"][0]
    results["rms_norm"] = {k: v for k, v in row.items()
                           if k not in ("name", "route", "source", "replaces", "launches")}


def only_report(results: dict, launches: dict, cases: dict = KIMI_CASES) -> None:
    """The kernels line and the ok line of ``--only kimi`` or ``--only norm``."""
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **results[name]}
        for name, (src, tpu) in cases.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("kimi", "norm"), default=None,
                    help="run the card, build and this phase alone (kimi: phase 26; norm: 27)")
    # phase 24c starts this script again as each of its two ranks
    ap.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--train-mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        mesh_rank_main(args.mesh_rank, 2, args.mesh_store, args.mesh_out, args.seed)
        return
    if args.train_mesh_rank is not None:  # phase 25c-e starts it as each of its two ranks
        train_mesh_rank_main(args.train_mesh_rank, 2, args.mesh_store, args.mesh_out, args.seed)
        return

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    log("card", torch=torch.__version__, cuda=torch.version.cuda,
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    kernels.library()
    seconds = time.perf_counter() - t0
    regs = [line.split("Used ")[1].split(",")[0]
            for line in (kernels.build_dir() / "build.log").read_text().splitlines()
            if "Used " in line]
    log("build", seconds=round(seconds, 3), dir=kernels.build_dir().name, registers=regs)
    if args.only == "kimi":
        results = {}
        kimi_launches = kimi_phase(dev, args.seed, results)
        only_report(results, kimi_launches)
        return
    if args.only == "norm":
        results = {}
        norm_phase(dev, args.seed, results)
        only_report(results, {"rms_norm": norm_run_phase(dev, args.seed)}, NORM_KERNELS)
        return

    cfg = Qwen25VLConfig()  # Qwen2.5-VL-7B, bf16
    proc = O3VideoProcessor()
    reqs = make_requests(proc, cfg, args.seed)
    rows = [len(r.input_ids) for r in reqs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    results = kernel_phase(dev, cfg, gen, rows, max(rows) + MAX_TOKENS)

    t0 = time.perf_counter()
    params = P.init(cfg, args.seed, dev)
    torch.cuda.synchronize()
    log("init", params=P.count(params), seconds=round(time.perf_counter() - t0, 3))
    engine = InferenceEngine(params, cfg)
    sampling = SamplingParams(temperature=0.7, top_p=0.001, repetition_penalty=1.05,
                              max_tokens=MAX_TOKENS, seed=args.seed)
    outs, launches, decode = slice_phase(engine, reqs, sampling)
    launches["rms_norm"] = norm_launches("video slice", cfg, decode, "slice")
    log("slice", first_token_ids=[o["token_ids"][:8] for o in outs])

    numerics_phase(params, cfg, reqs)
    eager_pair("video slice", params, cfg, reqs, sampling, outs, decode)
    early_stop_check(params, cfg, reqs[0])

    long_tokens, long_launches, long_decode = long_phase(params, cfg, args.seed)
    long_numerics_phase(params, cfg)
    for name, n, dtype in LONG_RUNS:  # each run again, decoding eagerly
        eager = InferenceEngine(params, cfg, cache_dtype=dtype, long_prefill_chunk=LONG_CHUNK,
                                decode_graph=False)
        again, _, eager_decode = long_run(eager, n, long_sampling(args.seed))
        decode_pair(f"run ({name})", long_decode[name], eager_decode, long_tokens[name], again)
        del eager
        torch.cuda.empty_cache()
    # K4's main path is run (b), the 81920-slot fp8 one
    launches["decode_attention_gqa"] = long_launches["b"]["decode_attention_gqa"]

    # the training slice, after the serving engines and caches are freed
    del engine, outs
    gc.collect()
    torch.cuda.empty_cache()
    batch = sft_batch(proc, cfg, args.seed)
    training_kernel_phase(dev, cfg, gen, batch, results)
    t0 = time.perf_counter()
    launches.update(sft_phase(params, cfg, batch))
    gc.collect()  # the AdamW state
    torch.cuda.empty_cache()
    train_numerics_phase(params, cfg, batch)
    log("sft", phases_seconds=round(time.perf_counter() - t0, 3))

    # GSPO: PEFT on the frozen 7B, its numerics, then the full fine-tune branch
    t0 = time.perf_counter()
    trainer, gsample, gspo_launches = gspo_phase(params, cfg, proc, args.seed)
    gspo_rollout_pair(trainer, gsample)
    gspo_numerics_phase(params, cfg, trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    ft_launches = gspo_full_phase(params, cfg, proc, gsample, args.seed)
    log("gspo", phases_seconds=round(time.perf_counter() - t0, 3),
        launches_per_step={"peft": gspo_launches, "full fine-tune": ft_launches})

    # the SFT app: media, the PEFT SFT step of the 7B, sft_main end to end
    t0 = time.perf_counter()
    sft_app_phase(params, cfg, proc, args.seed)
    log("sft_app", phases_seconds=round(time.perf_counter() - t0, 3))

    # eval: V-STAR, TVGBench, the MCQ core with TTS and the CLI on the 7B
    t0 = time.perf_counter()
    try:
        results_file, eval_launches = eval_phase(params, cfg, args.seed)
    except BaseException:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
        raise
    gc.collect()
    torch.cuda.empty_cache()
    log("eval", phases_seconds=round(time.perf_counter() - t0, 3), launches=eval_launches)

    # the serving scheduler: slots, the ring, chunked prefill, the prefix cache, max_kv_gb
    sched_launches = scheduler_phase(params, cfg, proc, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log("sched", launches=sched_launches)

    # speculative decoding: greedy, GSPO's sampled rollouts, long context
    spec_launches = spec_phase(params, cfg, reqs, proc, long_tokens["a"], args.seed, results)
    log("spec", launches=spec_launches)

    # the uint8 frame path and w8a8 serving
    serving_modes_phase(params, cfg, proc, args.seed)

    # Qwen3-VL-8B and Qwen2-VL-7B: K2 at head_dim 72, whole-frame towers
    family_kernel_launches = families_phase(dev, args.seed, results)

    # their training: the 7B is released for the 8B's AdamW state, then drawn
    # again from --seed for the int4 phases (their bf16 reference is
    # whatever weights they quantize, so phase 9's 3 updates play no part)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("train_families", released_7b_allocated_gib=round(torch.cuda.memory_allocated() / 2**30, 3))
    family_kernel_launches.update(training_families_phase(dev, args.seed, results))
    # Qwen3-VL-30B-A3B and Aria: the routed experts, Aria's tower and
    # projector, Request.vision_embeds
    family_kernel_launches.update(moe_families_phase(dev, args.seed, results))
    # their training: PEFT at full width and depth, a full fine-tune at a cut
    family_kernel_launches.update(train_moe_families_phase(dev, args.seed, results))
    params = P.init(cfg, args.seed, dev)

    # int4 serving: K7 and the probes, the 7B slice in int4, the 72B judge
    t0 = time.perf_counter()
    int4_kernel_phase(dev, gen, len(reqs) * max(rows), results)
    probe_launches = probe_phase(dev, gen, results)
    for name in ("int4_matmul_stream", "int4_matmul_convert"):  # their own path
        launches[name] = probe_launches[name]
    with torch.no_grad():
        bf16_logits = _vision_and_logits(params, cfg, reqs, "auto")[1]
        qparams = i4.quantize_params_int4(params)
    del params  # the bf16 decoder; qparams shares the ViT, embedding, norms, biases
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches = int4_slice_phase(qparams, cfg, reqs, sampling, bf16_logits)
    launches.update({name: int4_launches[name] for name in K7_ROUTES})
    del qparams, bf16_logits
    gc.collect()
    torch.cuda.empty_cache()
    try:
        judge_launches = judge_phase(dev, args.seed, results_file)
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
    log("int4", phases_seconds=round(time.perf_counter() - t0, 3), judge_k7_launches=judge_launches)

    # serving on a mesh: one NCCL rank, the shard shapes, two gloo ranks, a GIF
    gc.collect()
    torch.cuda.empty_cache()
    family_kernel_launches.update(mesh_phase(dev, args.seed, results))
    # training on a mesh: one NCCL rank, K5/K6 at shard shapes, two gloo ranks
    gc.collect()
    torch.cuda.empty_cache()
    family_kernel_launches.update(train_mesh_phase(dev, args.seed, results))
    # Kimi-VL: the MLA kernels, K2 at MoonViT's frames, the family's generate
    gc.collect()
    torch.cuda.empty_cache()
    family_kernel_launches.update(kimi_phase(dev, args.seed, results))
    # RMSNorm at the cells' shapes, in a process of its own (its launches are phase 4's)
    gc.collect()
    torch.cuda.empty_cache()
    norm_process(args.seed, results)

    log("total", seconds=round(time.perf_counter() - t_start, 3))
    print(card_line(), flush=True)  # again, so that the output's tail holds it
    launches.update(family_kernel_launches)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **results[name]}
        for name, (src, tpu) in {**TPU_KERNELS, **FAMILY_CASES, **FAMILY_TRAIN_CASES,
                                 **MOE_FAMILY_CASES, **MOE_TRAIN_CASES, **MESH_CASES,
                                 **TRAIN_MESH_CASES, **KIMI_CASES, **NORM_KERNELS}.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
