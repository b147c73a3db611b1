"""Chip smoke run of the PyTorch / H100 port (``mustafar_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, each printing one flushed JSON line with its ``phase`` and
``elapsed_s``:
  env           torch / CUDA versions, the card's name and power limit, which
                of the harness's optional packages import (safetensors,
                tokenizers, jinja2, rouge, jieba) and which corpus roots of
                the harness exist (none: the interpreter's standard library
                is read instead, and the line says so)
  build         nvcc builds the eleven kernel libraries at once (csrc/q_decode.cu,
                csrc/q_decode_ps.cu, csrc/q_segment.cu, csrc/sp_decode.cu: the
                bitmap uniform and per-slot entries, csrc/sp_segment.cu, both
                with an instance per value width (16 and 8 bits),
                csrc/w4_matmul.cu, csrc/dense_decode.cu,
                csrc/prune_quant_pack.cu, and the archive's
                csrc/sp_archive_spmv.cu, csrc/sp_archive_fused.cu and
                csrc/sp_archive_stream.cu) and prints ptxas per instance
  kernel        the uniform decode kernel against its plain PyTorch version on
                the card, at the flagship per-layer shapes (B=8, Hq=32, Hkv=8,
                mc=5), groups 1/2/4/8, bf16 and f32 q, also against its split
                plain version, a second launch bit-equal to the first and
                refusing short scratch; timed at 1 chunk + 288 window and at
                the full pool, beside the plain version's time and its bound;
                its window probabilities (return_win_probs) against the
                split plain version's within 2^-18 absolute, and its final
                (m, l) (return_norm) as kernel_dense holds kernel 4's, the
                output bit-equal with either option off, each timed on and
                off in turns; its sliding window (WINDOW_CASES: the edge
                inside a chunk, on a chunk and on a 64-token boundary,
                chunks wholly below it, vacuous) against both plain
                versions, and again at serve_swa's own decode shapes
                (SWA_SERVED: B=4, 17 chunks + 49..288 window tokens and 18
                after the compaction, window 4,096; bf16 and f32 q), timed
                on and off in turns at the serve_swa shape (SWA_TIMED)
                beside each's byte bound (live chunks only); its counts
                int32 tensors on the card that the kernel reads, and one
                CUDA graph of it replayed across changing counts
                (GRAPH_COUNTS: a new window length, a new chunk, nothing to
                attend; GRAPH_WINDOW_COUNTS: a window's edge moving through
                chunk 0 and past it), each replay bit-equal to an eager
                launch and within 2 bf16 ulps of the plain version
                (graph_replays)
  kernel_ps     the per-slot decode kernel likewise, at the engine's pool
                (mc=32): mixed slots (n_chunks 0/1/2/5/31, win_len
                0/1/44/288, an idle slot), groups 1/2/4/8; the kernel
                (split-K, every codec) also against its split plain
                version, and refusing short scratch; its window
                probabilities against the split plain version's within
                2^-18 absolute (0 past each slot's window, an idle slot's
                all 0), the output bit-equal with the option off, timed on
                and off in turns; its sliding window (PS_WINDOW_CASES:
                Mistral's 4,096 at the engine's slots, 31 chunks with 15 or
                16 below the edge, and 288 / 320 at the kit's: edges inside
                a chunk, on a boundary, every chunk below, vacuous, idle
                slots, different edges in one call), G 1/2/4/8, bf16 and f32
                q, against both plain versions, a second launch bit-equal,
                the window probabilities within 2^-18; timed with the window
                on and off in turns at the mixed slots with the 8,000-token
                one at 31 chunks + 160, beside each's byte bound (live
                chunks)
  kernel_seg    the segment kernel likewise: Tseg=256, G=4, B = 1 and 2,
                n_chunks 0/1/4/31, a second launch bit-equal to the first;
                timed at 31 chunks (the bitmap codecs' with their cluster
                size and the clusters the card holds), the quant codecs' also
                at 1, 4 and 16 (the counts serve_cb launches it at), each
                beside its bound; its sliding window (SEG_WINDOW_CASES:
                window 4,096 at seg_start 7,936 over 30 chunks, 288 and 320
                over 1 and 4, rows with no live pool column), B = 1 and 2:
                the live rows' partials against the plain version, every
                row merged with a self partial, no NaN, a second launch
                bit-equal; timed on and off in turns at 31 chunks beside
                each's bound (live rows and columns).  n_chunks and seg_start
                are int32 tensors on the card, which the kernel reads; one
                CUDA graph of the kernel, captured once over them, replayed
                across 9 (n_chunks, seg_start) pairs and 8 more with a
                window of 1,024 (SEG_GRAPH_*), B = 1 and 2: every replay's
                partials bit-equal to an eager launch at those counts
  kernel_q8, kernel_ps_q8, kernel_seg_q8, and the same for q4q4
                the three phases above at the codecs q8 and q4q4
  kernel_sp, kernel_sp_ps, kernel_sp_seg
                the bitmap codec's three kernels likewise, at the shapes of
                the three phases above, over real packed chunks (random bf16
                K and V pruned and encoded on the card) at sparsity 0.7, and
                0.5 (zero pads in the rows)
  kernel_sp_q8, kernel_sp_ps_q8, kernel_sp_seg_q8
                the same for the bitmap-q8 codec: the kernels' 8-bit
                instances over chunks pruned, quantized and encoded on the
                card, with their bf16 scales
  kernel_pack   the prune + quantize + pack kernel (TPU kernel 9) against its
                plain version, bit-equal: 64 and 8 head-chunks of 256 tokens,
                bits 8 and 4, keep 40/14/128, ties, a zero row, the score
                option, C = 128, 384 and 512, every cluster size, the cache's
                strided views; K and V in one launch (q8q4, q8, q4q4) in
                prefill's chunk layout and a compaction's layer layout,
                writing nothing outside their views, and with a score on V,
                on K or on both (the Opa packs); timed beside its byte
                bound and the plain chain: K alone, K+V at 64 and 8
                head-chunks, a 32-layer compaction in one launch and in the
                2 x 32 launches it took before, each K+V shape at every
                cluster size, and K+V at 64 with V scored and not, in turns
  kernel_w4     the W4 matmul kernel against its plain version at every
                Llama-3-8B projection shape and the fused wqkv / w_gateup, T = 8
                and 32 (and 1, 13, 100, 128 at one shape), a second launch
                bit-equal to the first, refusing a short workspace; timed
                beside its byte bound (and its share of it), the W8 proj and
                a bf16 matmul of the same shape
  kernel_dense  the dense flash-decode kernel (split-K) against its plain
                version and its split plain version (a tighter gate: see
                split_gate), refusing short scratch: B=8, S=1,312, pos 599
                and per slot at S=8,448 (a slot at 8,000, an idle one), both
                timed beside scaled_dot_product_attention; its final (m, l)
                (return_norm) against the split plain version's, the output
                bit-equal with the option off, timed on and off in turns;
                its sliding window (DENSE_WINDOWS: serve_swa's cache at pos
                4,500 and the per-slot cache) against both plain versions,
                timed on and off in turns beside each's byte bound and
                scaled_dot_product_attention with the band as its mask
  kernel_archive
                the archive's generations (TPU kernels 10-16: over split
                pools the v1 pair sparse_key_scores / sparse_value_combine,
                v2, v3; over the fused stream v4, v5, v6) against their plain
                versions, and the v1 chain against its plain chain, on random
                chunks pruned and packed on the card (prune_and_encode_chunk
                and _stream; v3's pools a chunk-major copy): B=8, Hkv=8,
                mc=5, W=288, sparsity 0.7 and 0.5, G 1/2/4/8, (n_chunks,
                win_len) (0, 44), (1, 288), (2, 1), (5, 288), (5, 0); v6's
                partials (acc, m, l) against the plain partials, v6 with
                window 300 and 600 at 5 chunks, v5 at hpb 8 and 2; nothing
                to attend (v1 and v6 NaN, v2-v4 the head's window mean, v5
                the mean over its TPU grid step's hpb heads, at hpb 8 and
                2); v2 and v3 (kernels 12 and 13, one CTA a softmax step)
                also against their split plain versions (split_gate), the
                window mean included, at G=4 with an f32 q too (its output
                rounded the bf16 q's), and each in one CUDA graph replayed
                across ARCHIVE_GRAPH_COUNTS written into its count tensors,
                every replay the eager launch's bits; then the ladder:
                device ms of kernels 10 and 11, the v1 chain, v2-v5, kernel
                16 alone, the whole v6 and kernel 6 beside their bounds and
                plain versions at (a) B=8, 1 chunk + 288 window and (b)
                B=32, 3 chunks + 132 window (G=4); the phase's seconds
  reference     a tiny f32 model decoded on the card (kernel) and on the CPU
                (plain path) with the same token stream: logits must agree
  reference_cb  the tiny f32 continuous-batching engine (chunked, interleaved
                admission, a slot retired and reused) likewise
  reference_bitmap, reference_bitmap_q8
                the two reference runs above with the bitmap and bitmap-q8
                codecs
  reference_q   the two reference runs above with the codecs q8 and q4q4
  reference_w4  a tiny W4 model, card (kernel 5, and kernel 4 for the dense
                cache with use_pallas, or the q8q4 kernel) against CPU
  reference_masked
                reference on the masked cache for all eight pruning
                methods (the Opa ones through kernel 4, with its (m, l)
                where V is scored)
  reference_opa reference on the compressed cache under KT_OPA_VT_MAG and
                KT_MAG_VT_OPA at every codec: a 543-token prompt packed by
                its prefill scores, a compaction by the accumulated scores,
                the window probabilities of kernels 1 and 6
  reference_opa_cb
                reference_cb under KT_OPA_VT_MAG and KT_MAG_VT_OPA at q8q4
                and bitmap: per-slot decode scoring each slot's window
                (kernels 2 and 7 with their window probabilities),
                compactions by score and chunked prefill's streamed scores;
                every greedy pick equal or at a near-tie (OPA_CB_NOTE)
  reference_swa reference on a tiny model with a sliding window of 320: a
                600-token prompt (banded prefill), decode steps that leave
                pool chunk 0 below the window, every codec (kernels 1 and 6
                with the window), the dense cache through kernel 4 and the
                masked cache; every greedy pick equal, or a flip at a
                near-tie within SWA_TIE_TOL (a fixed bound; see
                SWA_PICKS_NOTE)
  reference_swa_cb
                the window (320) through the engine over the compressed
                cache at every codec (kernels 2 and 7, 3 and 8 with the
                window) and the chunked Generator at q8q4 and bitmap, card
                against CPU; picks as reference_swa's; the per-slot and
                segment kernels 2 x steps and 2 x segments (the tiny model's
                2 layers)
  reference_sample
                sampled decoding (temperature 0.9, top-k 50, top-p 0.95,
                seed 7) through the Generator and the engine on the card:
                every drawn token in the kept set of the CPU's filter on
                the card's logits, the same seed the same tokens, top-k 1
                the greedy tokens; at top-p 0 and -0.5 token 0 every draw
  reference_w8a8
                W8A8: torch._int_mm's int32 accumulators bit-equal to the
                CPU's at the projection shapes (weights row- and
                column-major; 8 and 300 rows), timed beside the W8
                projection; a tiny f32 Llama in W8A8 through the dense,
                masked and q8q4 caches card against CPU (A8_SPREAD_NOTE)
  reference_moe a tiny f32 model with Mixtral's MLP (4 experts, top-2,
                capacity factor 1) card against CPU: prefill logits in
                f32, W8 experts, W8A8, W4 attention with W8 experts
                (kernel 5); greedy decoding through the q8q4, bitmap and
                dense (kernel 4) Generator and the q8q4 engine
  reference_sharded
                the trained ckpt/tiny-acc (f32, 2 kv heads) through the engine
                at dp=2 x tp=2: four processes on this card over gloo, the
                requests of tests/test_torch_scheduler_sharded.py on the
                q8q4, masked and bitmap-q8 caches; and reference_moe's tiny
                MoE (2 kv heads) at dp=1 x tp=2, experts over "model", and
                at dp=2 x tp=2 with 32 slots (every data group routing the
                whole batch, whose rows overflow an expert's slots): every
                rank's tokens equal one card rank's and the CPU's; each
                rank's per-slot kernel 4 times (the layers) a decode step of
                its own, the data groups' kernel 9 launches summing to one
                rank's; on a
                host with four cards, the engine again over nccl, one card a
                rank (else a line says it was not run)
  dist_recovery ``python -m mustafar_tpu_torch.parallel.distributed`` on this
                card, two processes over gloo at tp=2: the q8q4 step
                program's timed decode (16 steps; kernel 1 2 x 16 and
                kernel 9 2 a rank) and, side by side with it, the failure
                drill (a snapshot a step; process 1 exits at step 4, the
                survivor reports the loss within its 3 s barrier deadline);
                recovery from the drill's snapshot at tp=1 in this
                process, token for token the timed run's
  reference_ring
                the SP prefill on the tiny f32 model (2 kv heads): four
                processes on this card over gloo, sp=2 x tp=2 and sp=2, the
                dense cache and the masked cache under every prune family
                (RING_METHODS), 512 tokens (true length 500), then 4 decode
                steps through kernel 4: every rank's logits within SP_TOL of
                one card rank's (RANGE_TOL of their range where tp cuts the
                heads) and its picks equal, that rank's within RANGE_TOL of
                the range of the CPU's, kernel 4 2 x 4 a rank; over nccl on a
                host with four cards (else a line says it was not run)
  serve_q8q4    full-width, 32-layer Llama-3-8B with random W8 weights made
                on the card: Generator.generate, B=8, prompt 300, 300 new
                tokens, q8q4 compressed cache (one compaction on the way);
                every decode step must launch the kernel once per layer, and
                kernel 9 (K and V in one launch) once a layer for prefill's
                chunk and once for the compaction of every layer: 33
                launches.  Every Generator and engine of the run decodes
                through its CUDA graph (the card's default: the graph's
                captured launches x replays count with the eager ones,
                ``_launches``), unless a phase says it runs eagerly
  serve_dense   the same prompts through the dense baseline cache
  kernel_archive_cache
                the archive's main path on serve_dense's own cache: K and V
                of all 32 layers, rows 0-511 as two chunks (split pools and
                fused streams, the streams one stacked pool read a layer view
                at a time), rows 512-598 the window; per layer v1-v6 and
                kernel 6 must agree (3e-2 v2 against v1 and v4 against v2,
                2e-2 v3 and kernel 6 against v2, v5 and v6 against v4), each
                launched once a layer
  serve_bitmap  serve_q8q4 with the bitmap codec (the JAX package's default):
                bitmap decode kernel launches = 32 x 299; first tokens =
                serve_dense's
  serve_bitmap_q8
                serve_bitmap with the bitmap-q8 codec (the capacity codec):
                the same launches; first tokens = serve_dense's; its peak
                memory and pool bytes beside serve_bitmap's
  serve_dense_kernel
                serve_dense with use_pallas: the dense cache through its
                flash-decode kernel, 32 launches a step; first tokens =
                serve_dense's
  serve_q8, serve_q4q4
                serve_q8q4 with the codecs q8 and q4q4 (the same launch
                counts); first tokens = serve_dense's
  serve_masked, serve_masked_opa, serve_opa_q8q4, serve_opa_bitmap
                the masked cache, 100 new tokens (EngineConfig defaults:
                KT_MAG_VT_MAG at 0.5, no kernel; KT_MAG_VC_OPA at 0.7
                through kernel 4 with its (m, l), 32 x 99 launches) and Opa
                in the compressed cache, 300 (KT_MAG_VT_OPA at 0.7: kernel
                1 or 6 with its window probabilities 32 x 299, kernel 9
                with V's scores 33 for q8q4); first tokens = serve_dense's
  serve_graph   the compiled decode against the eager loop, Llama-3-8B W8
                at full width and depth, B=8, 300 + 300: serve_q8q4's,
                serve_bitmap's and serve_dense's graphed runs beside the
                same runs through the eager loop (graph=False): tokens
                equal, the graph's captured launches x 299 replays = the
                gate (32 x 299) and the eager run's launches; wall ms a
                token, a step's device ms (a replay between CUDA events;
                an eager step under a long spin), replays, peak memory.
                serve_graph_w4 (in serve_w4, before its cut): the same for
                W4 q8q4 at 32 layers
  decode_split  device time of a decode step's W8 projections, LM head and
                attention kernel, each timed alone, beside the step's wall time
  serve_cb      the continuous-batching engine at full width and 8 of the 32
                layers (CUT_LAYERS): 8 slots, 17 requests (one
                of 8,000 prompt tokens), chunked interleaved admission;
                per-slot and segment kernel launches = 8 x decode steps and
                8 x segments; first tokens = a batch-1 chunked
                Generator's; the slot bookkeeping in the native core
                (native/scheduler.cpp, built with g++), whose stats must
                show every request admitted and finished and none refused
                (every serve_cb* phase); the engine's tick a CUDA graph and
                its admission segments replays of one captured segment, and
                the same requests again through the eager engine: tokens and
                launches equal, both engines' tick times printed (a segment
                + decode tick's among them; every serve_cb* phase but
                serve_cb_bitmap_q8, whose program serve_cb_bitmap's rerun
                holds at the other value width and host_split bit for bit)
  serve_cb_bitmap, serve_cb_bitmap_q8
                serve_cb with the bitmap and bitmap-q8 codecs (peak memory
                and pool bytes side by side), at 8 of the 32 layers
                (CUT_LAYERS: 8 x steps and segments)
  serve_cb_q4q4 serve_cb with the q4q4 codec on its first 8 requests (8 of
                the 32 layers, CUT_LAYERS)
                without the 8,000-token one; kernel 9 (K and V in one
                launch) once a layer a segment (its staged pack) and once
                for every compaction (q8q4 and q4q4)
  serve_cb_opa  serve_cb's first 8 requests (q8q4) under KT_MAG_VT_OPA at
                0.7, 8 of the 32 layers (CUT_LAYERS): kernel 2 with its window
                probabilities 8 x decode steps, kernel 3 8 x segments, kernel
                9 at the same packing
                counts (V ranked by its scores); first tokens = a batch-1
                chunked Generator's under the same method; V's scores live
                at the end
  serve_cb_tp   serve_cb's first 8 requests through the engine on Llama-3-8B
                at full width and 8 of its 32 layers (CUT_LAYERS), W8
                (random, seed 0), q8q4 at 0.7, tp=2: two processes on this
                card over gloo, each making the weights and cutting its
                shard; first tokens equal one rank's, the first decode
                step's logits within TP_BF16_TOL of their range, each rank's
                kernels 2 and 3 8 x steps and segments, kernel 9 at the
                packing counts; an untimed tick's wall ms beside the
                collective ms of the timed ticks (every other tick, each
                all-reduce bracketed by synchronizes); over nccl,
                one card a rank, where the host has two cards (else a line
                says it was not run)
  serve_sp_prefill
                Llama-3-8B at full width and 8 of its 32 layers (CUT_LAYERS),
                W8 (random, seed 0), B=2 prompts of 8,192 tokens, the dense
                cache: the SP prefill at sp=2 (two processes on this card
                over gloo), then 16 decode steps through kernel 4 (8 x 16 a
                rank); first tokens equal one rank's monolithic prefill, the
                prefill's and first step's logits within TP_BF16_TOL of
                their range; a rank's prefill ms, its hops' ms and share,
                each rank's peak memory; over nccl where the host has two
                cards
  serve_pp      Llama-3-8B at full width and depth, W8 (random, seed 0), two
                pipeline stages (two processes over gloo), B=8, 300 + 32, 2
                microbatches, the dense cache with kernel 4 (16 x 31 x 2 a
                stage): every token and the logits equal to one rank running
                the same schedule; a decode step's wall ms and its hops'
                share; then PP x TP on the tiny model (four processes, pp=2 x
                tp=2, dense and masked Opa); over nccl where the host has
                two (four) cards
  serve_chunked Generator with chunked prefill at full width, B=4, 2,000 + 64,
                graphed (one segment captured, 7 replays) against eager:
                tokens equal, launches 32 x 8 segments and 32 x 63 steps in
                each; the prefill alone timed (enqueue, wall, device ms,
                kernels); the segment graph's capture time and pool
  serve_swa_dense, serve_swa_dense_kernel, serve_swa_q8q4, serve_swa_bitmap
                Mistral-7B with its 4,096 window (MISTRAL_7B_SWA), full
                width, 8 of its 32 layers (CUT_LAYERS), W8 (random, seed 0),
                B=4, prompt 4,400 (banded prefill), 300 new tokens (chunk 0
                below the window from the first step; one compaction): the
                dense cache plain and through kernel 4, q8q4 (kernel 1,
                kernel 9) and bitmap (kernel 6) with the window, 8 x 299
                decode launches; first tokens =
                serve_swa_dense's; tok/s, prefill seconds, peak memory
  serve_cb_swa_q8q4, serve_cb_swa_bitmap
                serve_cb's requests (17, one of 8,000 tokens) through the
                engine on Mistral-7B with its window, full width, at 8 of
                the 32 layers (CUT_LAYERS): the per-slot and segment kernels
                with the window 8 x steps and 8 x segments (kernel 9 for
                q8q4), first tokens = a
                batch-1 chunked Generator's; tok/s, peak memory, tick times
  serve_swa_chunked
                the chunked Generator on Mistral-7B (serve_swa's 8 layers),
                B=4, serve_swa's 4,400-token prompt (18 segments) + 64,
                graphed (the windowed segment captured, 17 replays) and
                eager: tokens equal; kernel 3 8 a segment, kernel 1 8 a
                step, kernel 9 8 a segment (its staged pack) in each;
                token agreement with serve_swa_q8q4
  host_split    one segment (B=1) at q8q4, bitmap and bitmap-q8, eager and
                as a replay of its segment graph (capture time and pool
                beside; cache state bit-equal), one K and V pack of a chunk
                at each, one decode tick (8 slots, q8q4) and
                one each of q8q4 and bitmap with an 8,000-token slot: host
                enqueue time, wall time, device time and kernels launched;
                at 8 of the 32 layers (CUT_LAYERS)
  slot_core     the engine's slot bookkeeping alone, host us a tick (one
                fill, a commit a busy slot; 8 slots, 64 requests of 300 +
                64), the native core against the Python rule kept for a
                host without g++; both admit and retire all 64
  serve_w4_dense, serve_w4_q8q4, serve_w4_bitmap
                the Generator at full width and 8 of the 32 layers
                (CUT_LAYERS) with W4 weights (init_params_w4,
                seed 0), B=8, 300 + 300: W4 kernel 7 x 8 and the cache's
                decode kernel 8 a step (the dense cache through its kernel);
                first tokens = serve_w4_dense's
  decode_split_w4
                decode_split for the W4 step, per cache
  serve_cb_w4   serve_cb with W4 weights on the bitmap codec: its first 8
                requests without the 8,000-token one, at 8 of the 32 layers
                (CUT_LAYERS); the eager engine's tokens equal
  serve_w8a8_dense, serve_w8a8_q8q4
                Llama-3-8B in W8A8 (serve_q8q4's W8 weights with
                enable_act_quant) at 8 of its 32 layers (CUT_LAYERS), B=8,
                300 + 100: kernel 1 8 x 99 and kernel 9 8 at q8q4, first
                tokens equal; the W8A8 step's projections and LM head,
                device ms
  serve_moe_dense, serve_moe_q8q4, serve_moe_bitmap
                Mixtral-8x7B (MIXTRAL_8X7B) at full width, W8 (init_params_w8,
                seed 0, 43.5 GiB for the 32 layers, made after every other
                model is freed), the Generator at 8 of the 32 layers
                (CUT_LAYERS), B=8, 300 + 100: kernel 1 / kernel 6 8 x 99,
                kernel 9 8 at q8q4, first tokens = serve_moe_dense's;
                tok/s, prefill seconds, peak memory, and a decode step's
                MoE MLP device ms beside its byte bound and the attention
                projections' ms
  serve_cb_moe  serve_cb's 17 requests through the engine at q8q4 on
                Mixtral-8x7B at full width and 8 of its 32 layers
                (CUT_LAYERS): kernels 2 and 3 8 x steps and segments,
                kernel 9 at the packing counts, first tokens = a batch-1
                chunked Generator's; the eager engine's tokens equal
  harness_predict
                the LongBench harness (predict_dataset, evaluate_dir) on
                Llama-3-8B at full width and 8 of its 32 layers
                (CUT_LAYERS), W8 (this run's params), synthetic passkey /
                passage_retrieval_en / trec rows (2 each, ~3,000 bytes of
                context), byte tokenizer, model name Meta-Llama-3-8B, one row
                a generate call, q8q4 at 0.7 and the dense twin: kernel 1 8
                x the rows' decode steps, kernel 9 8 a packing prefill and 1
                a compaction, first tokens =
                the dense twin's, all three tasks scored; tok/s and the
                longest prompt's prefill seconds
  harness_accuracy
                ``python -m mustafar_tpu_torch accuracy`` (a subprocess on
                the card) on the trained ckpt/tiny-acc: 16 passkey rows of
                1,600 bytes, dense, masked, bitmap, q8q4, q8q4 chunked and
                q8q4 with W4 weights at 0.7 (kernels 1, 3, 5, 6, 9, each
                at least at ACCURACY_FLOOR a layer), then ``eval`` on the
                dense variant; each variant's passkey accuracy, NLL and KL
                beside the JAX package's recorded rows; dense passkey
                accuracy at least 90 %
  reference_harness
                run_accuracy in process on the card and on the CPU (4 rows,
                384 NLL tokens, bitmap and q8q4 at 0.7): passkey accuracy
                equal, NLL and KL within 1e-3, predictions equal or parted
                at a near-tie (SWA_PICKS_NOTE)
  train_tiny    training on the card: step 1 of TINY_ACC at 8 x 2,048 (remat)
                from the same weights on the card and the CPU (loss and
                gradient norm within TRAIN_TOL), then ``train`` for 20 steps
                (the loss falls), its checkpoint read back on the card and
                the CPU and a passkey row greedy-decoded to the same tokens
Then the card's ``nvidia-smi`` line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
nothing is caught.  With no CUDA card, or run from a directory that holds
this file and not the port, it exits non-zero before printing a result.
"""

import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
BUDGET_S = 1100            # the run is cut, with a traceback, past this
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores (the decode kernels' math)
H100_BF16_FLOPS = 989e12   # bf16 tensor cores, dense (the segment kernel's math)
KERNEL_TOL_ULPS = 2        # bf16 ulps of the output's scale
SPLIT_TOL = 2.0 ** -10     # of the slot's scale, against the kernel's own arithmetic
SPLIT_TOL_NOTE = ("against the split plain version: its f32 result rounded to the "
                  "output's dtype, within 2^-10 of the slot's largest output")
# why library_ms is null for the attention kernels over compressed pools:
# scaled_dot_product_attention (the one PyTorch attention call) takes
# dense K and V, so it would first need the pool decoded, another function
NO_LIBRARY = {
    "quant": ("no single PyTorch call attends over int8 / int4 codes in int16 "
              "carriers with per-chunk scales; scaled_dot_product_attention "
              "needs dense K and V"),
    "bitmap": ("no single PyTorch call attends over bitmap streams (bf16 values "
               "or int8 codes with scales); scaled_dot_product_attention needs "
               "dense K and V"),
    "archive": ("no single PyTorch call reads the archive's bitmap formats (split pools "
                "of bf16 value segments and uint32 word planes, or the fused int16 "
                "stream): torch.sparse products take COO / CSR / BSR layouts and "
                "scaled_dot_product_attention dense K and V, so the pools would first "
                "be converted (another function)"),
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 4_000_000   # ~2 ms of the card's clock: longer than a wrapper's host work


def cuda_ms(fn, reps, flush=None, spin=True, spin_cycles=SPIN_CYCLES):
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, and how
    many of them the card waited on the host for.  Before each call
    ``flush`` runs (if given).  With ``spin`` a spin kernel then holds the
    stream while the host enqueues the start event, ``fn``'s launches and
    the end event, so the events bracket the card's work and not the
    wrapper's host time: a kernel's device time.  A call whose start event
    the card had passed before ``fn`` returned may include host time; the
    second value counts them (expected 0 with ``spin``).  Without ``spin``
    the events also hold the host's enqueue wherever the card waits for it,
    as for a plain version of many small launches: its time as a caller
    sees it.  ``spin_cycles`` lengthens the spin for a call whose host work
    takes longer than the default's ~2 ms."""
    import torch
    total, behind = 0.0, 0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        behind += bool(start.query())
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps, behind


def in_turns(ms):
    """An option's times taken in turns on, off, off, on -> the least of
    each pair (one slow repetition, a host hiccup, moves a mean of 100 by
    several us) and the four."""
    return {"on": min(ms[0], ms[3]), "off": min(ms[1], ms[2]), "in_turns": ms}


def split_gate(got, want32, live):
    """Worst error over tolerance, over the ``live`` slots, of a split
    kernel's output ``got`` [B, 1, Hq, D] against its split plain version's
    f32 result ``want32`` on the same inputs: ``got`` must be ``want32``
    rounded to its dtype (half a bf16 ulp of each bf16 element) within
    SPLIT_TOL of the slot's largest output.  Tighter than the gate against
    the TPU order, which allows 2 bf16 ulps of the scale."""
    import torch
    dims = (1, 2, 3)
    err = (got.float() - want32).abs()
    tol = SPLIT_TOL * want32.abs().amax(dim=dims, keepdim=True)
    if got.dtype == torch.bfloat16:
        exp = torch.frexp(got.float()).exponent
        half_ulp = torch.ldexp(torch.ones_like(err), exp - 9)   # 8 significant bits
        tol = tol + torch.where(got == 0, torch.zeros_like(err), half_ulp)
    return (err / tol.clamp_min(1e-30)).amax(dim=dims)[live].max().item()


def refuses_short_scratch(call):
    """Whether a split kernel's C entry refuses scratch one float short of
    what its grid needs (``call`` launches it through its wrapper)."""
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    kept = qa._split_scratch
    qa._split_scratch = lambda BH, n_splits, G, *a: \
        kept(BH, n_splits, G, *a)[:BH * n_splits * G * 130 - 1]
    try:
        call()
    except RuntimeError as e:
        return "CUDA error 1" in str(e)          # cudaErrorInvalidValue
    finally:
        qa._split_scratch = kept
    return False


def refuses_short_workspace(call):
    """Whether the W4 kernel's C entry refuses a workspace one float short,
    and counters one short, of what its grid needs (``call`` launches it
    through its wrapper, the wrapper's own check bypassed)."""
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    kept, kept_check = w4._workspace, w4._check_workspace
    refused = []
    for cut in ((1, 0), (0, 1)):
        def short(part, *a, cut=cut):
            ws, counters = kept(part, *a)
            return (ws[:part.ws_floats - cut[0]], counters[:part.n_counters - cut[1]])
        w4._workspace, w4._check_workspace = short, lambda *a: None
        try:
            call()
            refused.append(False)
        except RuntimeError as e:
            refused.append("CUDA error 1" in str(e))           # cudaErrorInvalidValue
        finally:
            w4._workspace, w4._check_workspace = kept, kept_check
    return all(refused)


def host_us(fn, reps):
    """Mean host microseconds a call of ``fn`` takes to return (its
    launches enqueued, not run)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import mustafar_tpu_torch
    pkg = os.path.dirname(os.path.abspath(mustafar_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        raise SystemExit(f"chip_smoke: the port must come from this checkout, "
                         f"found {pkg}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         tf32=False, harness_imports=_optional_imports(), corpus=_corpus_roots())
    return smi


def _optional_imports():
    """Which of the harness's optional packages import here (``predict``
    from an HF directory reads safetensors with ``safetensors``, the
    tokenizer with ``tokenizers``, a chat template with ``jinja2``), with
    their versions."""
    import importlib
    found = {}
    for name in ("safetensors", "tokenizers", "jinja2", "rouge", "jieba"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "?")
        except ImportError:
            found[name] = None
    return found


def _corpus_roots():
    """The harness's corpus roots (``tinylm._CORPUS_ROOTS``, the JAX
    package's) that exist here; where none does, the roots become this
    interpreter's standard library, and the line says so."""
    import sysconfig
    from mustafar_tpu_torch.harness import tinylm
    roots = list(tinylm._CORPUS_ROOTS)
    found = [r for r in roots if os.path.isdir(r)]
    if found:
        return {"roots": roots, "found": found, "replaced": False}
    tinylm._CORPUS_ROOTS = [sysconfig.get_paths()["stdlib"]]
    return {"roots": roots, "found": [], "replaced": True,
            "now": tinylm._CORPUS_ROOTS,
            "note": "none of the harness's corpus roots exists here: the corpus is read "
                    "from this interpreter's standard library instead"}


KERNEL_LIBS = ("q_decode", "q_decode_ps", "q_segment", "sp_decode", "sp_segment",
               "w4_matmul", "dense_decode", "prune_quant_pack", "sp_archive_spmv",
               "sp_archive_fused", "sp_archive_stream")
# (kbits, vbits) of the quant codecs, which kernels 1-3 and 9 serve
QUANT_BITS = {"q8": (8, 8), "q8q4": (8, 4), "q4q4": (4, 4)}


def phase_build():
    """nvcc builds the eleven kernel libraries at once, one process each."""
    from concurrent.futures import ThreadPoolExecutor
    from mustafar_tpu_torch.ops.kernels import build
    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        list(pool.map(build.load, KERNEL_LIBS))
    ptxas = {name: [ln.strip() for ln in build.BUILD_LOGS.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name in KERNEL_LIBS}
    emit("build", seconds=round(time.perf_counter() - t, 3),
         libraries=[str(build.library_path(n).relative_to(ROOT)) for n in KERNEL_LIBS],
         built_now=[n for n in KERNEL_LIBS if n in build.BUILD_LOGS], ptxas=ptxas)


class _Kit:
    """One codec's kernels over one stacked state, as the kernel phases
    call them: ``decode(q, n_chunks, win_len, li)`` and ``decode_ps``,
    ``segment(q_seg, n_chunks, li)`` and the plain versions beside each
    (and ``decode_split_plain`` and ``decode_ps_split_plain``, the decode
    kernels' split arithmetic), each decode with its options (``_wp``:
    window probabilities, ``_norm``: the final (m, l));
    ``chunk_bytes`` is what one pool chunk of one kv head holds (rows and,
    for the quant codecs and bitmap-q8, scales).  The uniform decode, the
    segment kernels (``segment(q_seg, n_chunks, li, seg_start, window)``,
    seg_start n_chunks * 256 by default) and their plain versions take their
    counts as the kernels read them, int32 tensors on the card (``count``:
    one per value, made once, so a timed call launches the kernel alone);
    callers pass ints or such tensors."""

    UNIFORM = ("decode", "decode_plain", "decode_split_plain", "decode_wp",
               "decode_split_plain_wp", "decode_norm", "decode_split_plain_norm")

    def count(self, n):
        """A count as the uniform kernels read it: a one-element int32
        tensor on the card, one per value."""
        import torch
        if torch.is_tensor(n):
            return n
        if n not in self._counts:
            self._counts[n] = torch.full((1,), n, dtype=torch.int32, device=self.k_win.device)
        return self._counts[n]

    def _device_counted(self):
        self._counts = {}
        for name in self.UNIFORM:
            fn = getattr(self, name)
            setattr(self, name, lambda q, nc, wl, li, _fn=fn, **o:
                    _fn(q, self.count(nc), self.count(wl), li, **o))
        # the segment kernels and their plain versions: n_chunks and
        # seg_start (n_chunks * 256 by default) as card tensors too
        for name in ("segment", "segment_plain"):
            fn = getattr(self, name)
            setattr(self, name, lambda q, nc, li, seg_start=None, window=None, _fn=fn:
                    _fn(q, self.count(nc), li,
                        self.count(nc * 256 if seg_start is None else seg_start), window))

    def __init__(self, codec, g, dev, L, mc, BH, W, sparsity=0.7):
        import torch
        from mustafar_tpu_torch.ops import quant_format as qf
        from mustafar_tpu_torch.ops import sparse_format as sf
        from mustafar_tpu_torch.ops.kernels import quant_attention as qa
        from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
        self.codec, self.sparsity = codec, sparsity
        self.k_win = torch.randn((L, BH, W, 128), generator=g, device=dev).to(torch.bfloat16)
        self.v_win = torch.randn((L, BH, W, 128), generator=g, device=dev).to(torch.bfloat16)
        kw, vw = self.k_win, self.v_win
        if codec in QUANT_BITS:
            # every int16 bit pattern is a valid set of int8 or int4 codes;
            # scales 0.002-0.02
            qc = qf.QuantCodec(256, 128, *QUANT_BITS[codec])
            rows = qc.stream_rows
            pool = torch.randint(-32768, 32768, (L, mc, BH, rows, 128), generator=g,
                                 device=dev, dtype=torch.int32).to(torch.int16)
            scales = (0.002 + 0.018 * torch.rand((L, mc, BH, 2, 128), generator=g,
                                                 device=dev)).to(torch.bfloat16)
            self.chunk_bytes = rows * 128 * 2 + 2 * 128 * 2
            self.fns = {"decode": qa.fused_q_decode_attention,
                        "decode_ps": qa.fused_q_decode_attention_ps,
                        "segment": qa.fused_q_segment_attention}
            self.decode = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc, **o)
            self.decode_plain = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention_plain(
                q, pool, scales, kw, vw, nc, wl, li, qc, **o)
            self.decode_split_plain = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_split_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                        qc, **o)
            self.decode_wp = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc, return_win_probs=True, **o)
            self.decode_split_plain_wp = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_split_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                        qc, win_probs=True, **o)
            self.decode_norm = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc, return_norm=True, **o)
            self.decode_split_plain_norm = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_split_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                        qc, norm=True, **o)
            self.decode_ps = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention_ps(
                q, pool, scales, kw, vw, nc, wl, li, qc, **o)
            self.decode_ps_wp = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention_ps(
                q, pool, scales, kw, vw, nc, wl, li, qc, return_win_probs=True, **o)
            self.decode_ps_plain = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_ps_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                     qc, **o)
            self.decode_ps_split_plain = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_ps_split_plain(q, pool, scales, kw, vw, nc, wl,
                                                           li, qc, **o)
            self.decode_ps_split_plain_wp = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_ps_split_plain(q, pool, scales, kw, vw, nc, wl,
                                                           li, qc, win_probs=True, **o)
            self.segment = lambda q, nc, li, seg_start, window: \
                qa.fused_q_segment_attention(q, pool, scales, nc, seg_start, li, qc,
                                             window=window)
            self.segment_plain = lambda q, nc, li, seg_start, window: \
                qa.fused_q_segment_attention_plain(q, pool, scales, nc, li, qc, seg_start,
                                                   window)
            self._device_counted()
            return
        # bitmap codecs: real packed chunks, random bf16 K and V pruned to
        # the format's keep (and quantized, bitmap-q8) and encoded on the
        # card (a stream of random bits would not hold the format's popcounts)
        qbits = 8 if codec == "bitmap-q8" else 16
        fmt = self.fmt = sf.ChunkFormat(256, 128, 128 - int(sparsity * 128) + 1,
                                        qbits=qbits)
        pool = torch.empty((L, mc, BH, 2 * fmt.stream_rows, 128), dtype=torch.int16,
                           device=dev)
        scales = (torch.empty((L, mc, BH, 2, 128), dtype=torch.bfloat16, device=dev)
                  if qbits == 8 else None)
        for li in range(L):
            x = torch.randn((mc, 2, BH, 256, 128), generator=g, device=dev)
            if qbits == 8:
                rows, sc = sf.prune_and_encode_stream_q8(x.to(torch.bfloat16), fmt)
                scales[li] = sc.to(torch.bfloat16).transpose(1, 2)   # [mc, BH, 2, 128]
            else:
                rows = sf.prune_and_encode_stream(x.to(torch.bfloat16), fmt)
            pool[li] = torch.cat([rows[:, 0], rows[:, 1]], dim=-2)
        self.chunk_bytes = 2 * fmt.stream_rows * 128 * 2 + (2 * 128 * 2 if qbits == 8 else 0)
        self.fns = {"decode": ska.fused_sparse_decode_attention,
                    "decode_ps": ska.fused_sparse_decode_attention_ps,
                    "segment": ska.fused_sparse_segment_attention}
        sc = {"kv_scales": scales}
        self.decode = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, **o)
        self.decode_plain = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention_plain(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, scales, **o)
        self.decode_split_plain = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_split_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                          fmt, scales, **o)
        self.decode_wp = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, return_win_probs=True, **o)
        self.decode_split_plain_wp = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_split_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                          fmt, scales, win_probs=True, **o)
        self.decode_norm = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, return_norm=True, **o)
        self.decode_split_plain_norm = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_split_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                          fmt, scales, norm=True, **o)
        self.decode_ps = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention_ps(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, **o)
        self.decode_ps_wp = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention_ps(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, return_win_probs=True, **o)
        self.decode_ps_plain = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_ps_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                       fmt, scales, **o)
        self.decode_ps_split_plain = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_ps_split_plain(q, pool, kw, vw, nc, wl, li,
                                                             fmt, fmt, scales, **o)
        self.decode_ps_split_plain_wp = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_ps_split_plain(q, pool, kw, vw, nc, wl, li,
                                                             fmt, fmt, scales, win_probs=True,
                                                             **o)
        self.segment = lambda q, nc, li, seg_start, window: \
            ska.fused_sparse_segment_attention(q, pool, nc, seg_start, li, fmt, fmt, **sc,
                                               window=window)
        self.segment_plain = lambda q, nc, li, seg_start, window: \
            ska.fused_sparse_segment_attention_plain(q, pool, nc, li, fmt, fmt, scales,
                                                     seg_start, window)
        self._device_counted()


# the kernels line's fixed fields, by codec family and kernel
KERNEL_META = {
    ("quant", "decode"): ("fused_q_decode_attention", "q_decode.cu",
                          "quant_attention.py:223"),
    ("quant", "decode_ps"): ("fused_q_decode_attention_ps", "q_decode_ps.cu",
                             "quant_attention.py:516"),
    ("quant", "segment"): ("fused_q_segment_attention", "q_segment.cu",
                           "quant_attention.py:704"),
    ("quant", "pack"): ("prune_quant_pack_kv", "prune_quant_pack.cu", "pack_kernel.py:101"),
    ("bitmap", "decode"): ("fused_sparse_decode_attention", "sp_decode.cu",
                           "sparse_attention.py:896"),
    ("bitmap", "decode_ps"): ("fused_sparse_decode_attention_ps", "sp_decode.cu",
                              "sparse_attention.py:417"),
    ("bitmap", "segment"): ("fused_sparse_segment_attention", "sp_segment.cu",
                            "sparse_attention.py:647"),
    ("w4", "matmul"): ("w4_matmul", "w4_matmul.cu", "w4_matmul.py:87"),
    ("dense", "decode"): ("flash_decode_attention", "dense_decode.cu", "dense_decode.py:92"),
    # the archive's names are prefixed: its v2 shares the production name
    ("archive", "key_scores"): ("archive.sparse_key_scores", "sp_archive_spmv.cu",
                                "sparse_attention_archive.py:98"),
    ("archive", "value_combine"): ("archive.sparse_value_combine", "sp_archive_spmv.cu",
                                   "sparse_attention_archive.py:158"),
    ("archive", "v2"): ("archive.fused_sparse_decode_attention", "sp_archive_fused.cu",
                        "sparse_attention_archive.py:314"),
    ("archive", "v3"): ("archive.fused_sparse_decode_attention_v3", "sp_archive_fused.cu",
                        "sparse_attention_archive.py:491"),
    ("archive", "v4"): ("archive.fused_sparse_decode_attention_v4", "sp_archive_stream.cu",
                        "sparse_attention_archive.py:630"),
    ("archive", "v5"): ("archive.fused_sparse_decode_attention_v5", "sp_archive_stream.cu",
                        "sparse_attention_archive.py:785"),
    ("archive", "v6"): ("archive.fused_sparse_decode_attention_v6", "sp_archive_stream.cu",
                        "sparse_attention_archive.py:916"),
}


def _family(codec):
    return ("quant" if codec in QUANT_BITS
            else "bitmap" if codec.startswith("bitmap") else codec)


def _meta(codec, kind):
    return KERNEL_META[(_family(codec), kind)]


def _phase_label(base, codec):
    """The phase's name: ``kernel``... for q8q4 (the names of earlier runs),
    ``kernel_sp``... for bitmap (``_q8`` after it for bitmap-q8),
    ``kernel..._q8`` / ``_q4q4`` else."""
    if codec == "q8q4":
        return base
    if codec.startswith("bitmap"):
        return base.replace("kernel", "kernel_sp", 1) + ("_q8" if codec == "bitmap-q8"
                                                         else "")
    return f"{base}_{codec}"


def _entry(codec, kind, results, worst, tol, kernel_ms, plain_ms, bytes_ms, flops_ms):
    name, src, tpu = _meta(codec, kind)
    return {"name": name, "route": "cuda", "source": f"mustafar_tpu_torch/csrc/{src}",
            "replaces": f"mustafar_tpu/ops/kernels/{tpu}", "launches": None,
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in results),
            "tol": tol, "worst_err_over_tol": worst,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None, "library_note": NO_LIBRARY.get(_family(codec))}


def phase_kernel(codec="q8q4"):
    """Uniform decode kernel vs plain at the flagship per-layer shapes (B=8,
    Hq=32, Hkv=8, L=4, mc=5); returns the kernels-line entry (launches
    filled in by the serve phase).  The bitmap codec is checked at sparsity
    0.7 and 0.5 and timed at 0.7.  Each case is held to the TPU-order plain
    version and to the kernel's split plain version (``split_gate``); a
    second launch must give the same bits, and the C entry must refuse
    short scratch.  Timed at 1 chunk + 288 window and at the full pool."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B, Hq, Hkv, L, mc, W, D = 8, 32, 8, 4, 5, 288, 128
    BH = B * Hkv
    kits = [_Kit(codec, g, dev, L, mc, BH, W, sp)
            for sp in ((0.7,) if codec in QUANT_BITS else (0.7, 0.5))]
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    cases = [(0, 1, 0), (0, 44, L - 1), (0, 288, 0), (mc, 288, L - 1), (mc, 1, 0),
             (1, 44, 0), (1, 288, L - 1), (2, 88, 0)]
    # the other query-group sizes the kernel is built for (Llama-3-8B has 4)
    other_groups = [torch.randn((B, 1, Hkv * g_, D), generator=g, device=dev
                                ).to(torch.bfloat16) for g_ in (1, 2, 8)]
    fn = kits[0].fns["decode"]
    launches0 = fn.launches
    results, worst, worst_split = [], 0.0, 0.0
    every_row = torch.ones(B, dtype=torch.bool, device=dev)
    for kit in kits:
        for nc, wl, li in cases:
            for qq in (q, q.float(), *other_groups):
                got = kit.decode(qq, nc, wl, li)
                again = kit.decode(qq, nc, wl, li)
                torch.cuda.synchronize()
                want = kit.decode_plain(qq, nc, wl, li)
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                # the TPU's steps, f32 sums in another order and p rounded at
                # each split's own max: a bf16(p) or the bf16 output may move
                # by one ulp each
                tol = KERNEL_TOL_ULPS * 2.0 ** -8 * scale
                split = split_gate(got, kit.decode_split_plain(qq.float(), nc, wl, li),
                                   every_row)
                results.append({"sparsity": kit.sparsity, "n_chunks": nc, "win_len": wl,
                                "li": li, "q_dtype": str(qq.dtype).split(".")[-1],
                                "G": qq.shape[2] // Hkv, "max_abs_err": err, "tol": tol,
                                "worst_err_over_tol_split": split,
                                "second_launch_equal": bool(torch.equal(got, again))})
                if not (got.isfinite().all() and err <= tol and split <= 1.0
                        and results[-1]["second_launch_equal"]):
                    raise AssertionError(f"kernel disagrees with its plain versions or "
                                         f"with itself: {results[-1]}")
                worst = max(worst, err / max(tol, 1e-30))
                worst_split = max(worst_split, split)

    probs_cases, probs_worst = _check_win_probs(kits[0], (q, q.float()), cases + [(0, 0, 0)])
    more, worse = _check_win_probs(kits[0], other_groups, cases[:2])
    probs_cases, probs_worst = probs_cases + more, max(probs_worst, worse)
    norm_cases, norm_worst = _check_uniform_norm(kits[0], (q, q.float()),
                                                 cases + [(0, 0, 0)])
    more, worse = _check_uniform_norm(kits[0], other_groups, cases[:2])
    norm_cases, norm_worst = norm_cases + more, max(norm_worst, worse)
    window = _check_windows(kits, q, other_groups, L)
    graph_cases = _check_graph_counts(kits[0], q, L - 1)

    # time at the main path's largest pre-compaction shape: one pool chunk
    # and a full 288-token window, L2 flushed before each launch
    kit = kits[0]
    nc, wl, li = 1, 288, 0
    if not refuses_short_scratch(lambda: kit.decode(q, nc, wl, li)):
        raise AssertionError("uniform kernel took scratch shorter than its grid needs")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for _ in range(10):
        kit.decode(q, nc, wl, li)
        kit.decode_plain(q, nc, wl, li)
    for _ in range(200):                 # the kernel alone, a few ms, before timing it
        kit.decode(q, nc, wl, li)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.decode(q, nc, wl, li), 100,
                                flush=flush_buf.zero_)
    plain_ms, _ = cuda_ms(lambda: kit.decode_plain(q, nc, wl, li), 20,
                          flush=flush_buf.zero_, spin=False)
    hot_ms, _ = cuda_ms(lambda: kit.decode(q, nc, wl, li), 100)
    full_ms, _ = cuda_ms(lambda: kit.decode(q, mc, 288, li), 100, flush=flush_buf.zero_)
    # the window probabilities on and off, in turns
    probs_ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
                for call in (lambda: kit.decode_wp(q, nc, wl, li),
                             lambda: kit.decode(q, nc, wl, li),
                             lambda: kit.decode(q, nc, wl, li),
                             lambda: kit.decode_wp(q, nc, wl, li))]
    probs_plain_ms, _ = cuda_ms(lambda: kit.decode_split_plain_wp(q, nc, wl, li), 5,
                                flush=flush_buf.zero_, spin=False)
    # the final (m, l) on and off, in turns
    norm_ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
               for call in (lambda: kit.decode_norm(q, nc, wl, li),
                            lambda: kit.decode(q, nc, wl, li),
                            lambda: kit.decode(q, nc, wl, li),
                            lambda: kit.decode_norm(q, nc, wl, li))]
    norm_plain_ms, _ = cuda_ms(lambda: kit.decode_split_plain_norm(q, nc, wl, li), 5,
                               flush=flush_buf.zero_, spin=False)
    wrapper_us = host_us(lambda: kit.decode(q, nc, wl, li), 100)
    G = Hq // Hkv
    nbytes = (BH * (nc * kit.chunk_bytes + 2 * wl * 128 * 2)   # pools, windows
              + 2 * B * Hq * D * 2)                          # q in, out
    flops = BH * G * (nc * 256 + wl) * 128 * 2 * 2          # scores + p.v
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_FLOPS * 1e3
    fn.launches = launches0                               # comparisons do not count
    emit(_phase_label("kernel", codec), codec=codec,
         shapes={"B": B, "Hq": Hq, "Hkv": Hkv, "L": L, "mc": mc, "W": W},
         cases=results, worst_err_over_tol=worst, worst_err_over_tol_split=worst_split,
         kernel_ms=kernel_ms, kernel_ms_l2_hot=hot_ms,
         kernel_ms_full_pool=full_ms, plain_ms=plain_ms, host_behind=behind,
         wrapper_host_us=wrapper_us, win_probs_cases=probs_cases,
         win_probs_ms=dict(in_turns(probs_ms), split_plain=probs_plain_ms),
         return_norm_cases=norm_cases,
         return_norm_ms=dict(in_turns(norm_ms), split_plain=norm_plain_ms),
         window=window, graph_replays=graph_cases,
         timed_at={"sparsity": kit.sparsity, "n_chunks": nc, "win_len": wl},
         counts_on_device=True,
         bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    entry = _entry(codec, "decode", results, worst, max(r["tol"] for r in results),
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    entry["counts"] = ("int32 tensors on the card, read by the kernel (one entry for the "
                       "eager and the graphed decode); held in one CUDA graph across "
                       f"{sum(len(c['replays']) for c in graph_cases)} replays at changing "
                       "counts: graph_replays")
    entry.update(max_err=entry["max_abs_err"], worst_err_over_tol_split=worst_split,
                 tol_split=SPLIT_TOL_NOTE)
    entry["options"] = {"return_win_probs": {
        "max_abs_err": max(r["probs_max_abs_err"] for r in probs_cases),
        "tol": WIN_PROBS_TOL, "worst_err_over_tol": probs_worst,
        "ms": in_turns(probs_ms)["on"], "ms_off": in_turns(probs_ms)["off"],
        "plain_ms": probs_plain_ms, "launches": None,
        "timed_at": "as ms: 1 chunk + 288 window, in turns on, off, off, on (the least "
                    "of each pair)"},
        "return_norm": {
        "max_abs_err_m": max(r["m_max_abs_err"] for r in norm_cases),
        "max_rel_err_l": max(r["l_max_rel_err"] for r in norm_cases),
        "tol": NORM_TOL_NOTE, "worst_err_over_tol": norm_worst,
        "ms": in_turns(norm_ms)["on"], "ms_off": in_turns(norm_ms)["off"],
        "plain_ms": norm_plain_ms, "launches": 0,
        "launches_note": "no serving path asks for it (the JAX package's paths do not)",
        "timed_at": "as ms: 1 chunk + 288 window, in turns on, off, off, on (the least "
                    "of each pair)"},
        "window": _window_option(window)}
    return entry


GRAPH_COUNTS = ((1, 100), (1, 101), (1, 288), (2, 1), (2, 200), (0, 0), (3, 44), (5, 288))
GRAPH_WINDOW = 400
# at window 400: nothing below the edge; the edge inside chunk 0 (twice);
# chunk 0 wholly below it and the edge in chunk 1; chunks 0-1 below, edge in 2
GRAPH_WINDOW_COUNTS = ((1, 100), (1, 200), (2, 100), (2, 288), (4, 17))


def _check_graph_counts(kit, q, li):
    """The uniform kernel in one CUDA graph, captured once over two count
    tensors on the card and replayed after each new pair of counts is
    written into them (a new window length, a new chunk, nothing to attend,
    the full pool; and with a sliding window of ``GRAPH_WINDOW`` its edge
    moving through chunk 0 and past it): every replay's output bit-equal
    to an eager launch at the same counts and within 2 bf16 ulps of the
    output's scale of the plain version.  Returns the cases."""
    import torch
    cases = []
    for window, seq in ((None, GRAPH_COUNTS), (GRAPH_WINDOW, GRAPH_WINDOW_COUNTS)):
        nc_t = torch.full((1,), seq[0][0], dtype=torch.int32, device="cuda")
        wl_t = torch.full((1,), seq[0][1], dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kit.decode(q, nc_t, wl_t, li, window=window)      # scratch for this stream
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            res = kit.decode(q, nc_t, wl_t, li, window=window)
        replays = []
        for nc, wl in seq:
            nc_t.fill_(nc)
            wl_t.fill_(wl)
            graph.replay()
            got = res.clone()
            eager = kit.decode(q, nc, wl, li, window=window)
            want = kit.decode_plain(q, nc, wl, li, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL_ULPS * 2.0 ** -8 * max(want.float().abs().max().item(), 1e-30)
            replays.append({"n_chunks": nc, "win_len": wl, "max_abs_err": err, "tol": tol,
                            "equal_to_eager_launch": bool(torch.equal(got, eager))})
            if not (replays[-1]["equal_to_eager_launch"] and err <= tol
                    and bool(got.isfinite().all())):
                raise AssertionError(f"the graphed uniform kernel at new counts: "
                                     f"{replays[-1]} (window {window})")
        cases.append({"window": window, "li": li, "replays": replays})
        del graph
    return cases


def _window_option(w):
    """The kernels line's record of a kernel's sliding window, from the
    phase's window results (``launches`` filled by its serve_swa or
    serve_cb_swa phase)."""
    t = w["timed"]
    return {"max_abs_err": w["max_abs_err"], "tol": w["tol"],
            "worst_err_over_tol": w["worst_err_over_tol"],
            "worst_err_over_tol_split": w["worst_err_over_tol_split"],
            "ms": t["ms_on"], "ms_off": t["ms_off"], "bound_ms": t["bound_ms"],
            "bound_ms_off": t["bound_ms_off"], "bound_by": "bytes",
            "plain_ms": t["plain_ms"], "library_ms": t.get("library_ms"),
            "launches": None, "timed_at": t["timed_at"]}


# sliding-window cases of the uniform decode kernels at the flagship kit's
# shape (mc = 5, W = 288): (n_chunks, win_len, li, window); the decoded token
# is at n_chunks * 256 + win_len - 1 and the window keeps columns past
# low = that - window
WINDOW_CASES = (
    (5, 288, 3, 1000),     # low 567: chunks 0-1 left out, chunk 2 cut mid-run
    (5, 100, 0, 612),      # low 767: a chunk boundary, chunks 0-2 left out
    (5, 100, 0, 548),      # low 831: a 64-token step boundary inside chunk 3
    (3, 288, 3, 500),      # low 555: chunk 2 cut
    (1, 288, 0, 300),      # low 243: the only chunk cut
    (5, 288, 0, 288),      # low 1279: every chunk left out, the window alone
    (5, 1, 0, 4096))       # vacuous: nothing masked
# the serve_swa shape the window is timed at: Mistral-7B's B=4, 8 kv heads,
# G=4; 17 chunks (a 4,400-token prompt) and 160 window tokens: position
# 4,511, window 4,096, low 415
SWA_TIMED = {"B": 4, "Hkv": 8, "G": 4, "mc": 19, "n_chunks": 17, "win_len": 160,
             "window": 4096}
# (n_chunks, win_len) of serve_swa's decode steps the kernels are held at
# there: its decodes run at 17 chunks + 49..288 window tokens, then (after
# the compaction) 18 + 33..91.  The first step (low 304: chunk 0 left out,
# chunk 1 cut), the timed one (low 415), a chunk boundary (low 511: chunks
# 0-1 left out), the last before the compaction (low 543), the first and
# the last after it (low 544, 602)
SWA_SERVED = ((17, 49), (17, 160), (17, 256), (17, 288), (18, 33), (18, 91))


def _hold_windows(kit, cases, qs_of):
    """The uniform decode kernel with a sliding window at each case
    (n_chunks, win_len, li, window), for each q of ``qs_of(case index)``:
    held to the TPU-order plain version at 2 bf16 ulps of the output's
    scale and to its split plain version by ``split_gate``, a second launch
    bit-equal.  Returns (the cases, the worst error over each tolerance)."""
    import torch
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    results, worst, worst_split = [], 0.0, 0.0
    for i, (nc, wl, li, window) in enumerate(cases):
        for qq in qs_of(i):
            B = qq.shape[0]
            got = kit.decode(qq, nc, wl, li, window=window)
            again = kit.decode(qq, nc, wl, li, window=window)
            torch.cuda.synchronize()
            want = kit.decode_plain(qq, nc, wl, li, window=window)
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().max().item()
            split = split_gate(got, kit.decode_split_plain(qq.float(), nc, wl, li,
                                                           window=window),
                               torch.ones(B, dtype=torch.bool, device=qq.device))
            results.append({"sparsity": kit.sparsity, "B": B, "n_chunks": nc,
                            "win_len": wl, "li": li, "window": window,
                            "low": qa.window_low(nc, wl, window),
                            "q_dtype": str(qq.dtype).split(".")[-1],
                            "G": qq.shape[2] // (kit.k_win.shape[1] // B),
                            "max_abs_err": err, "tol": tol,
                            "worst_err_over_tol_split": split,
                            "second_launch_equal": bool(torch.equal(got, again))})
            if not (got.isfinite().all() and err <= tol and split <= 1.0
                    and results[-1]["second_launch_equal"]):
                raise AssertionError(f"windowed kernel disagrees with its plain "
                                     f"versions or with itself: {results[-1]}")
            worst = max(worst, err / max(tol, 1e-30))
            worst_split = max(worst_split, split)
    return results, worst, worst_split


def _check_windows(kits, q, other_groups, L):
    """The uniform decode kernel with a sliding window (``_hold_windows``):
    at WINDOW_CASES with f32 and bf16 q, and the other groups at the first
    two cases; the window probabilities and (m, l) with a window at the
    first case.  Then, at SWA_TIMED, held at serve_swa's own shapes and
    timed with the window on and off, in turns (``_time_window``)."""
    results, worst, worst_split = [], 0.0, 0.0
    for kit in kits:
        got = _hold_windows(kit, WINDOW_CASES,
                            lambda i: (q, q.float(), *(other_groups if i < 2 else ())))
        results += got[0]
        worst, worst_split = max(worst, got[1]), max(worst_split, got[2])
    probs, probs_worst = _check_win_probs(kits[0], (q, q.float()), WINDOW_CASES[:1])
    norm, norm_worst = _check_uniform_norm(kits[0], (q, q.float()), WINDOW_CASES[:1])
    timed = _time_window(kits[0].codec, kits[0].sparsity)
    results += timed.pop("cases")
    worst = max(worst, timed.pop("worst_err_over_tol"))
    worst_split = max(worst_split, timed.pop("worst_err_over_tol_split"))
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": "2 bf16 ulps of the output's scale (TPU order); " + SPLIT_TOL_NOTE,
            "worst_err_over_tol": worst, "worst_err_over_tol_split": worst_split,
            "win_probs_cases": probs, "win_probs_worst": probs_worst,
            "return_norm_cases": norm, "return_norm_worst": norm_worst,
            "timed": timed}


def _time_window(codec, sparsity):
    """The uniform decode kernel at SWA_TIMED's B, heads and window: first
    held (``_hold_windows``, bf16 and f32 q) at the serve_swa phases' own
    counts (SWA_SERVED), then timed at SWA_TIMED's with the window on and
    off, in turns on, off, off, on (the least of each pair), L2 flushed;
    the byte bounds count the chunks each reads (with the window, those
    with a live column)."""
    import torch
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    s = SWA_TIMED
    B, Hkv, G, nc, wl, window = (s[k] for k in ("B", "Hkv", "G", "n_chunks", "win_len",
                                                "window"))
    BH = B * Hkv
    kit = _Kit(codec, g, dev, 1, s["mc"], BH, 288, sparsity)
    q = torch.randn((B, 1, Hkv * G, 128), generator=g, device=dev).to(torch.bfloat16)
    fn = kit.fns["decode"]
    launches0 = fn.launches
    held, worst, worst_split = _hold_windows(
        kit, [(c, w, 0, window) for c, w in SWA_SERVED], lambda i: (q, q.float()))
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for _ in range(20):
        kit.decode(q, nc, wl, 0, window=window)
        kit.decode(q, nc, wl, 0)
    torch.cuda.synchronize()
    ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
          for call in (lambda: kit.decode(q, nc, wl, 0, window=window),
                       lambda: kit.decode(q, nc, wl, 0), lambda: kit.decode(q, nc, wl, 0),
                       lambda: kit.decode(q, nc, wl, 0, window=window))]
    plain_ms, _ = cuda_ms(lambda: kit.decode_plain(q, nc, wl, 0, window=window), 3,
                          flush=flush_buf.zero_, spin=False)
    fn.launches = launches0
    live = nc - qa.masked_steps(nc, wl, window, 256)        # chunks with a live column

    def bound(chunks):
        nbytes = BH * (chunks * kit.chunk_bytes + 2 * wl * 128 * 2) + 2 * q.numel() * 2
        flops = BH * G * (chunks * 256 + wl) * 128 * 2 * 2
        return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    turns = in_turns(ms)
    return {"timed_at": f"B={B}, Hkv={Hkv}, G={G}, {nc} chunks + {wl} window, window "
                        f"{window} (low {qa.window_low(nc, wl, window)}: {nc - live} chunk "
                        f"left out), in turns on, off, off, on (the least of each pair)",
            "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
            "live_chunks": live, "bound_ms": bound(live), "bound_ms_off": bound(nc),
            "plain_ms": plain_ms, "cases": held, "worst_err_over_tol": worst,
            "worst_err_over_tol_split": worst_split}


def _check_uniform_norm(kit, qs, cases):
    """The uniform decode kernel's final (m, l) (``return_norm``) against its
    split plain version's (NORM_TOL_NOTE; nothing to attend: -1e30 and 0
    from both), and the output with the option bit-equal to the output
    without it.  A case (n_chunks, win_len, li) may add a sliding window.
    Returns (the cases, the worst error over the tolerance)."""
    import torch
    results, worst = [], 0.0
    for nc, wl, li, *window in cases:
        o = {"window": window[0]} if window else {}
        for qq in qs:
            out, m, l = kit.decode_norm(qq, nc, wl, li, **o)
            plain = kit.decode(qq, nc, wl, li, **o)
            torch.cuda.synchronize()
            _, want_m, want_l = kit.decode_split_plain_norm(qq.float(), nc, wl, li, **o)
            m_err = (m - want_m).abs().max().item()
            l_err = ((l - want_l).abs() / want_l.clamp_min(1.0)).max().item()
            results.append({"n_chunks": nc, "win_len": wl, "li": li, **o,
                            "q_dtype": str(qq.dtype).split(".")[-1], "G": m.shape[2],
                            "m_max_abs_err": m_err, "l_max_rel_err": l_err,
                            "out_equal_without": bool(torch.equal(out, plain))})
            if not (results[-1]["out_equal_without"] and m_err <= NORM_TOL
                    and l_err <= NORM_TOL):
                raise AssertionError(f"uniform decode kernel's (m, l) disagree with its "
                                     f"split plain version's, or change the output: "
                                     f"{results[-1]}")
            worst = max(worst, max(m_err, l_err) / NORM_TOL)
    return results, worst


WIN_PROBS_TOL = 2.0 ** -18   # absolute, of probabilities summed over <= 8 heads


def _check_win_probs(kit, qs, cases):
    """The uniform decode kernel's window probabilities (``return_win_probs``)
    against its split plain version's, within WIN_PROBS_TOL absolute (the
    scores and the merged (m, l) are the plain version's bit for bit; expf
    and the division differ by an ulp or so), 0 at and past ``win_len``,
    and the output with the option bit-equal to the output without it.  A
    case (n_chunks, win_len, li) may add a sliding window.  Returns (the
    cases, the worst error over the tolerance)."""
    import torch
    results, worst = [], 0.0
    for nc, wl, li, *window in cases:
        o = {"window": window[0]} if window else {}
        for qq in qs:
            out, probs = kit.decode_wp(qq, nc, wl, li, **o)
            plain = kit.decode(qq, nc, wl, li, **o)
            torch.cuda.synchronize()
            _, want = kit.decode_split_plain_wp(qq.float(), nc, wl, li, **o)
            err = (probs - want).abs().max().item()
            ok = (bool(torch.equal(out, plain)) and bool(probs.isfinite().all())
                  and err <= WIN_PROBS_TOL and bool((probs[..., wl:] == 0).all()))
            results.append({"n_chunks": nc, "win_len": wl, "li": li, **o,
                            "q_dtype": str(qq.dtype).split(".")[-1],
                            "G": qq.shape[2] // probs.shape[1], "probs_max_abs_err": err,
                            "out_equal_without": bool(torch.equal(out, plain))})
            if not ok:
                raise AssertionError(f"window probabilities disagree with the split plain "
                                     f"version (tol {WIN_PROBS_TOL}) or change the "
                                     f"output: {results[-1]}")
            worst = max(worst, err / WIN_PROBS_TOL)
    return results, worst


def phase_kernel_ps(codec="q8q4"):
    """Per-slot decode kernel vs its plain version at the engine's pool
    shape (B=8 slots, Hkv=8, mc=32 as at ``serve_cb``'s max_seq_len 8448):
    mixed slots with n_chunks 0/1/2/5/31 and win_len 0/1/44/288 (the
    31-chunk slot is the 8,000-token request's decode), an idle slot (0, 0)
    among them, query groups 1/2/4/8, bf16 and f32 q (the bitmap codec at
    sparsity 0.7 and 0.5).  Timed at these slots and, beside them, at the
    lighter mix of earlier runs (0-5 chunks).  Every codec's kernel
    (split-K) is also held to its split plain version (``split_gate``) and
    must refuse short scratch."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    B, Hkv, L, mc, W, D = 8, 8, 4, 32, 288, 128
    BH = B * Hkv
    kits = [_Kit(codec, g, dev, L, mc, BH, W, sp)
            for sp in ((0.7,) if codec in QUANT_BITS else (0.7, 0.5))]
    slots = [(0, 0), (0, 1), (1, 44), (2, 288), (5, 288), (5, 1), (1, 0), (31, 288)]
    light = slots[:-1] + [(2, 44)]          # the slots timed before mc = 32

    def counts(sl):
        return (torch.tensor([c for c, _ in sl], dtype=torch.int32, device=dev),
                torch.tensor([w for _, w in sl], dtype=torch.int32, device=dev))

    nc, wl = counts(slots)
    fn = kits[0].fns["decode_ps"]
    launches0 = fn.launches
    results, worst, worst_split = [], 0.0, 0.0
    for kit in kits:
        for G in (1, 2, 4, 8):
            qb = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
            for qq in (qb, qb.float()):
                for li in (0, L - 1):
                    results.append(_hold_ps(kit, qq, nc, wl, li))
                    worst = max(worst, results[-1]["worst_err_over_tol"])
                    worst_split = max(worst_split, results[-1]["worst_err_over_tol_split"])

    # the window probabilities (return_win_probs) at every group size
    kit = kits[0]
    qs = [torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
          for G in (4, 1, 2, 8)]
    probs_cases, probs_worst = _check_ps_win_probs(kit, [qs[0], qs[0].float(), *qs[1:]],
                                                   nc, wl, W)
    window = _check_ps_windows(kit, qs, counts, slots)

    # time at the serving shape (G=4), the mixed slots above, L2 flushed
    q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
    if not refuses_short_scratch(lambda: kit.decode_ps(q, nc, wl, 0)):
        raise AssertionError("per-slot kernel took scratch shorter than its grid needs")
    if not refuses_short_scratch(lambda: kit.decode_ps_wp(q, nc, wl, 0)):
        raise AssertionError("per-slot kernel took scratch shorter than its grid needs "
                             "(with the window probabilities)")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for _ in range(10):
        kit.decode_ps(q, nc, wl, 0)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.decode_ps(q, nc, wl, 0), 100,
                                flush=flush_buf.zero_)
    plain_ms, _ = cuda_ms(lambda: kit.decode_ps_plain(q, nc, wl, 0), 10,
                          flush=flush_buf.zero_, spin=False)
    lnc, lwl = counts(light)
    light_ms, _ = cuda_ms(lambda: kit.decode_ps(q, lnc, lwl, 0), 100,
                          flush=flush_buf.zero_)
    wrapper_us = host_us(lambda: kit.decode_ps(q, nc, wl, 0), 100)
    # the window probabilities on and off, in turns
    probs_ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
                for call in (lambda: kit.decode_ps_wp(q, nc, wl, 0),
                             lambda: kit.decode_ps(q, nc, wl, 0),
                             lambda: kit.decode_ps(q, nc, wl, 0),
                             lambda: kit.decode_ps_wp(q, nc, wl, 0))]
    probs_plain_ms, _ = cuda_ms(lambda: kit.decode_ps_split_plain_wp(q, nc, wl, 0), 3,
                                flush=flush_buf.zero_, spin=False)
    n_tok = sum(c * 256 + w for c, w in slots)
    nbytes = (Hkv * sum(c * kit.chunk_bytes + 2 * w * 128 * 2
                        for c, w in slots)                  # pools, windows
              + 2 * q.numel() * 2 + 2 * B * 4)              # q in, out, counts
    flops = Hkv * 4 * n_tok * D * 2 * 2                     # scores + p.v, G = 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_FLOPS * 1e3
    fn.launches = launches0                               # comparisons do not count
    emit(_phase_label("kernel_ps", codec), codec=codec,
         shapes={"B": B, "Hq": 4 * Hkv, "Hkv": Hkv, "L": L, "mc": mc, "W": W},
         slots=slots, cases=results, worst_err_over_tol=worst,
         worst_err_over_tol_split=worst_split, kernel_ms=kernel_ms,
         kernel_ms_light_slots=light_ms, light_slots=light, plain_ms=plain_ms,
         host_behind=behind, wrapper_host_us=wrapper_us, timed_at={"sparsity": kit.sparsity}, bytes=nbytes,
         flops=flops, bound_ms=max(bytes_ms, flops_ms), library_ms=None,
         win_probs_cases=probs_cases,
         win_probs_ms=dict(in_turns(probs_ms), split_plain=probs_plain_ms), window=window)
    entry = _entry(codec, "decode_ps", results, worst,
                   "per slot: 2 bf16 ulps of the slot's largest output",
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    entry.update(worst_err_over_tol_split=worst_split, tol_split=SPLIT_TOL_NOTE)
    entry["options"] = {"return_win_probs": {
        "max_abs_err": max(r["probs_max_abs_err"] for r in probs_cases),
        "tol": WIN_PROBS_TOL, "worst_err_over_tol": probs_worst,
        "ms": in_turns(probs_ms)["on"], "ms_off": in_turns(probs_ms)["off"],
        "plain_ms": probs_plain_ms, "launches": None,
        "timed_at": "as ms: the mixed slots, G=4, in turns on, off, off, on (the least of "
                    "each pair)"},
        "window": _window_option(window)}
    return entry


def _hold_ps(kit, qq, nc, wl, li, **o):
    """The per-slot kernel at counts ``nc``, ``wl`` (and a sliding window in
    ``o``) against its TPU-order plain version, each slot within 2 bf16 ulps
    of its own output scale (so a slot of small outputs, many chunks, is
    held as tightly as a one-token slot), an idle slot 0 and a live one
    not, and against its split plain version by ``split_gate``; a second
    launch bit-equal.  Returns the case; raises on a miss."""
    import torch
    got = kit.decode_ps(qq, nc, wl, li, **o)
    again = kit.decode_ps(qq, nc, wl, li, **o)
    torch.cuda.synchronize()
    want = kit.decode_ps_plain(qq, nc, wl, li, **o)
    dims = (1, 2, 3)
    errs = (got.float() - want.float()).abs().amax(dim=dims)
    tols = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().amax(dim=dims)
    live = (nc > 0) | (wl > 0)
    idle_zero = bool((got[~live] == 0).all())
    live_nonzero = bool((got.float().abs().amax(dim=dims)[live] > 0).all())
    ratio = (errs[live] / tols[live].clamp_min(1e-30)).max().item()
    case = {"sparsity": kit.sparsity, "G": qq.shape[2] // (kit.k_win.shape[1] // qq.shape[0]),
            "q_dtype": str(qq.dtype).split(".")[-1], "li": li, **o,
            "max_abs_err": errs.max().item(), "slot_err": errs.tolist(),
            "slot_tol": tols.tolist(), "worst_err_over_tol": ratio,
            "idle_slots_zero": idle_zero, "live_slots_nonzero": live_nonzero,
            "second_launch_equal": bool(torch.equal(got, again))}
    if not (got.isfinite().all() and ratio <= 1.0 and idle_zero and live_nonzero
            and case["second_launch_equal"]):
        raise AssertionError(f"per-slot kernel disagrees with its plain version or with "
                             f"itself: {case}")
    # the kernel's own arithmetic: splits merged
    case["worst_err_over_tol_split"] = split_gate(
        got, kit.decode_ps_split_plain(qq.float(), nc, wl, li, **o), live)
    if not case["worst_err_over_tol_split"] <= 1.0:
        raise AssertionError(f"per-slot kernel disagrees with its split plain version: "
                             f"{case}")
    return case


# per-slot sliding-window cases at kernel_ps's pool (mc = 32, W = 288):
# window -> the 8 slots' (n_chunks, win_len); slot b's edge is low =
# n_chunks * 256 + win_len - 1 - window, its first live chunk (low + 1) // 256
PS_WINDOW_CASES = {
    # Mistral's window at the engine's shape: the 8,000-token slot at 31
    # chunks + 160 (low 3,999: 15 chunks wholly below, chunk 15 cut) and at
    # 31 + 256 (low 4,095: 16 below, on a chunk boundary), 16 + 256 (low
    # 255: chunk 0 below), 17 + 160 (low 415: chunk 1 cut), an idle slot and
    # three the window covers
    4096: ((31, 160), (0, 0), (16, 256), (17, 160), (1, 44), (5, 288), (31, 256), (2, 1)),
    # test-size windows: low 479 (chunk 1 cut), 511 (chunks 0-1 below, on a
    # boundary), 960 (chunk 3 cut), idle, vacuous, 7,903 (30 below), 1,247
    # (chunk 4 cut), a slot with no chunk
    320: ((2, 288), (3, 64), (5, 1), (0, 0), (1, 44), (31, 288), (5, 288), (0, 232)),
    # low 511 (every chunk below: the window alone), 11 (chunk 0 cut), 992,
    # idle, 7,807, 835, 255 (the only chunk below), one token and no chunk
    288: ((2, 288), (1, 44), (5, 1), (0, 0), (31, 160), (4, 100), (1, 288), (0, 1)),
}
# the 8,000-token slot as serve_cb_swa decodes it: 31 chunks + 160 (15 of
# them wholly below Mistral's window), beside kernel_ps's other slots
PS_WINDOW_TIMED = 4096


def _check_ps_windows(kit, qs, counts, slots):
    """The per-slot kernel with a sliding window (``_hold_ps``) at each
    PS_WINDOW_CASES window, bf16 and f32 q at G=4 and bf16 at G=1/2/8 (qs:
    G = 4, 1, 2, 8), with its window probabilities within WIN_PROBS_TOL of
    the split plain version's; then timed with Mistral's window on and off,
    in turns, at kernel_ps's slots with the 8,000-token one at 31 chunks +
    160, beside each's byte bound (live chunks only)."""
    import torch
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    results, probs, worst, worst_split, probs_worst = [], [], 0.0, 0.0, 0.0
    for window, sl in PS_WINDOW_CASES.items():
        nc, wl = counts(sl)
        for qq in (qs[0], qs[0].float(), *(qs[1:] if window == 4096 else ())):
            results.append(dict(_hold_ps(kit, qq, nc, wl, 0, window=window),
                                slots=list(sl),
                                lows=[qa.window_low(c, w, window) for c, w in sl]))
            worst = max(worst, results[-1]["worst_err_over_tol"])
            worst_split = max(worst_split, results[-1]["worst_err_over_tol_split"])
        for qq in (qs[0], qs[0].float()):
            out, pr = kit.decode_ps_wp(qq, nc, wl, 0, window=window)
            plain = kit.decode_ps(qq, nc, wl, 0, window=window)
            torch.cuda.synchronize()
            _, want = kit.decode_ps_split_plain_wp(qq.float(), nc, wl, 0, window=window)
            err = (pr - want).abs().max().item()
            probs.append({"window": window, "q_dtype": str(qq.dtype).split(".")[-1],
                          "probs_max_abs_err": err,
                          "out_equal_without": bool(torch.equal(out, plain))})
            if not (probs[-1]["out_equal_without"] and err <= WIN_PROBS_TOL
                    and bool(pr.isfinite().all())):
                raise AssertionError(f"per-slot window probabilities with the window "
                                     f"disagree with the split plain version: {probs[-1]}")
            probs_worst = max(probs_worst, err / WIN_PROBS_TOL)
    q = qs[0]
    window = PS_WINDOW_TIMED
    timed_slots = [(c, 160) if c == 31 else (c, w) for c, w in slots]
    nc, wl = counts(timed_slots)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=q.device)
    for _ in range(10):
        kit.decode_ps(q, nc, wl, 0, window=window)
    torch.cuda.synchronize()
    ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
          for call in (lambda: kit.decode_ps(q, nc, wl, 0, window=window),
                       lambda: kit.decode_ps(q, nc, wl, 0), lambda: kit.decode_ps(q, nc, wl, 0),
                       lambda: kit.decode_ps(q, nc, wl, 0, window=window))]
    plain_ms, _ = cuda_ms(lambda: kit.decode_ps_plain(q, nc, wl, 0, window=window), 3,
                          flush=flush_buf.zero_, spin=False)
    Hkv = kit.k_win.shape[1] // q.shape[0]
    G = q.shape[2] // Hkv
    live = [c - qa.masked_steps(c, w, window, 256) for c, w in timed_slots]

    def bound(chunks):
        n_tok = sum(c * 256 + w for c, (_, w) in zip(chunks, timed_slots))
        nbytes = (Hkv * sum(c * kit.chunk_bytes + 2 * w * 128 * 2
                            for c, (_, w) in zip(chunks, timed_slots))
                  + 2 * q.numel() * 2 + 2 * q.shape[0] * 4)
        flops = Hkv * G * n_tok * 128 * 2 * 2
        return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    turns = in_turns(ms)
    timed = {"timed_at": f"the slots {timed_slots}, G={G}, window {window} (the 31-chunk "
                         f"slot's low {qa.window_low(31, 160, window)}: "
                         f"{31 - live[timed_slots.index((31, 160))]} chunks left out), "
                         f"in turns on, off, off, on (the least of each pair)",
             "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
             "live_chunks": sum(live), "chunks": sum(c for c, _ in timed_slots),
             "bound_ms": bound(live), "bound_ms_off": bound([c for c, _ in timed_slots]),
             "plain_ms": plain_ms}
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": "per slot: 2 bf16 ulps of the slot's largest output (TPU order); "
                   + SPLIT_TOL_NOTE,
            "worst_err_over_tol": worst, "worst_err_over_tol_split": worst_split,
            "win_probs_cases": probs, "win_probs_worst": probs_worst, "timed": timed}


def _check_ps_win_probs(kit, qs, nc, wl, W):
    """The per-slot kernel's window probabilities (``return_win_probs``)
    against its split plain version's, within WIN_PROBS_TOL absolute, each
    slot's 0 at and past its ``win_len`` (an idle slot's all 0), and the
    output with the option bit-equal to the output without it.  Returns
    (the cases, the worst error over the tolerance)."""
    import torch
    results, worst = [], 0.0
    past = (torch.arange(W, device=wl.device)[None, :] >= wl.clamp(0, W)[:, None])
    for qq in qs:
        out, probs = kit.decode_ps_wp(qq, nc, wl, 0)
        plain = kit.decode_ps(qq, nc, wl, 0)
        torch.cuda.synchronize()
        _, want = kit.decode_ps_split_plain_wp(qq.float(), nc, wl, 0)
        err = (probs - want).abs().max().item()
        zero_past = bool((probs.masked_select(past[:, None, :]) == 0).all())
        results.append({"q_dtype": str(qq.dtype).split(".")[-1],
                        "G": qq.shape[2] // probs.shape[1], "probs_max_abs_err": err,
                        "zero_past_win_len": zero_past,
                        "out_equal_without": bool(torch.equal(out, plain))})
        if not (results[-1]["out_equal_without"] and zero_past and err <= WIN_PROBS_TOL
                and bool(probs.isfinite().all())):
            raise AssertionError(f"per-slot window probabilities disagree with the split "
                                 f"plain version (tol {WIN_PROBS_TOL}) or change the "
                                 f"output: {results[-1]}")
        worst = max(worst, err / WIN_PROBS_TOL)
    return results, worst


def segment_clusters(fmt, T, G):
    """The bitmap segment kernel's clusters at T query tokens of G heads a
    kv head (``segment_grid``) and how many of them the card holds at once
    (``cudaOccupancyMaxActiveClusters`` for the format's shared memory)."""
    import ctypes
    import torch
    from mustafar_tpu_torch.ops.kernels import build
    from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
    cluster, tiles = ska.segment_grid(T, G)
    fn = build.load("sp_segment").sp_segment_max_clusters
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    n = ctypes.c_int(-1)
    rc = fn(ctypes.byref(n), torch.cuda.current_device(), fmt.qbits, *ska._segs(fmt),
            *ska._segs(fmt), cluster)
    if rc != 0:
        raise RuntimeError(f"sp_segment_max_clusters failed: CUDA error {rc}")
    return {"cluster": cluster, "row_tiles": tiles, "max_active_clusters": n.value}


def phase_kernel_seg(codec="q8q4"):
    """Segment kernel vs its plain version: Tseg=256, Hq=32 over Hkv=8
    (G=4), B = 1 and 2, n_chunks 0/1/4/31 (the bitmap codec at sparsity 0.7
    and, at B=1, 0.5); timed at the serving shape of the longest prompt's
    last segment (B=1, 31 chunks).  The bitmap codecs' kernel runs as
    thread block clusters: their size and how many the card holds at once
    go beside its time."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    Hq, Hkv, T, L, mc, D = 32, 8, 256, 2, 32, 128
    fn = None
    results, worst = [], 0.0
    kits = {}
    runs = [(1, 0.7), (2, 0.7)] + ([] if codec in QUANT_BITS else [(1, 0.5)])
    for B, sparsity in runs:
        kit = _Kit(codec, g, dev, L, mc, B * Hkv, 8, sparsity)
        kits[(B, sparsity)] = kit
        if fn is None:
            fn = kit.fns["segment"]
            launches0 = fn.launches
        qb = torch.randn((B, T, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        for nc in (0, 1, 4, 31):
            for qq, li in ((qb, nc % L), (qb.float(), (nc + 1) % L)):
                acc, m, l = kit.segment(qq, nc, li)
                torch.cuda.synchronize()
                pa, pm, pl = kit.segment_plain(qq, nc, li)
                if nc == 0:
                    exact = bool((acc == 0).all() and (m == -1e30).all() and (l == 0).all())
                    results.append({"B": B, "sparsity": sparsity, "n_chunks": 0, "li": li,
                                    "empty_exact": exact})
                    if not exact:
                        raise AssertionError(f"segment kernel, no chunk: {results[-1]}")
                    continue
                # normalised output within 2 bf16 ulps of its scale (the bf16
                # roundings of p may move by one ulp: other summation order);
                # m and l are f32 sums in another order
                out, pout = acc / l, pa / pl
                err = (out - pout).abs().max().item()
                tol = KERNEL_TOL_ULPS * 2.0 ** -8 * pout.abs().max().item()
                m_err = (m - pm).abs().max().item()
                m_tol = 1e-5 * pm.abs().max().item()
                l_err = ((l - pl).abs() / pl).max().item()
                l_tol = 1e-4
                results.append({"B": B, "sparsity": sparsity, "n_chunks": nc, "li": li,
                                "q_dtype": str(qq.dtype).split(".")[-1],
                                "max_abs_err": err, "tol": tol, "m_err": m_err,
                                "m_tol": m_tol, "l_rel_err": l_err, "l_tol": l_tol})
                if not (acc.isfinite().all() and err <= tol and m_err <= m_tol
                        and l_err <= l_tol):
                    raise AssertionError(f"segment kernel disagrees with its plain "
                                         f"version: {results[-1]}")
                worst = max(worst, err / max(tol, 1e-30), m_err / max(m_tol, 1e-30),
                            l_err / l_tol)

    window = _check_seg_windows(kits, g, Hq, Hkv, T, L)
    B, nc = 1, 31
    kit = kits[(B, 0.7)]
    q = torch.randn((B, T, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    graph_replays = {f"B{b}": _check_seg_graph(kits[(b, 0.7)], qq, 1)
                     for b, qq in ((1, q), (2, torch.randn((2, T, Hq, D), generator=g,
                                                           device=dev).to(torch.bfloat16)))}
    # the same inputs launched twice give the same bits
    first, again = kit.segment(q, nc, 0), kit.segment(q, nc, 0)
    same_bits = all(torch.equal(a, b) for a, b in zip(first, again))
    if not same_bits:
        raise AssertionError("segment kernel: a second launch on the same inputs "
                             "gave other bits")
    BH, QR = B * Hkv, T * Hq // Hkv

    def bounds(n):
        flops = 4 * BH * QR * n * 256 * D                    # scores + p.v, mul + add
        nbytes = (BH * n * kit.chunk_bytes                   # pools
                  + q.numel() * 2 + B * T * Hq * (D + 2) * 4)   # q in; acc, m, l out
        return flops, nbytes, nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3

    # the quant codecs at the chunk counts serve_cb launches them at
    by_chunks = {}
    for n in ((1, 4, 16) if codec in QUANT_BITS else ()):
        for _ in range(3):
            kit.segment(q, n, 0)
        torch.cuda.synchronize()
        ms, _ = cuda_ms(lambda: kit.segment(q, n, 0), 20)
        _, _, b_ms, f_ms = bounds(n)
        by_chunks[n] = {"kernel_ms": ms, "bound_ms": max(b_ms, f_ms),
                        "share_of_bound": max(b_ms, f_ms) / ms}
    for _ in range(3):
        kit.segment(q, nc, 0)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.segment(q, nc, 0), 20)
    plain_ms, _ = cuda_ms(lambda: kit.segment_plain(q, nc, 0), 3, spin=False)
    wrapper_us = host_us(lambda: kit.segment(q, nc, 0), 20)
    flops, nbytes, bytes_ms, flops_ms = bounds(nc)
    if by_chunks:
        by_chunks[nc] = {"kernel_ms": kernel_ms, "bound_ms": max(bytes_ms, flops_ms),
                         "share_of_bound": max(bytes_ms, flops_ms) / kernel_ms}
    fn.launches = launches0
    clusters = (segment_clusters(kit.fmt, T, Hq // Hkv) if _family(codec) == "bitmap"
                else None)
    emit(_phase_label("kernel_seg", codec), codec=codec,
         shapes={"Tseg": T, "Hq": Hq, "Hkv": Hkv, "L": L, "mc": mc},
         cases=results, worst_err_over_tol=worst, clusters=clusters,
         timed_at={"B": B, "n_chunks": nc, "sparsity": kit.sparsity},
         kernel_ms=kernel_ms, plain_ms=plain_ms, host_behind=behind,
         wrapper_host_us=wrapper_us, second_launch_same_bits=same_bits,
         kernel_ms_by_chunks=by_chunks or None,
         flops=flops, bytes=nbytes,
         bound_ms=max(bytes_ms, flops_ms), library_ms=None, window=window,
         counts="n_chunks and seg_start read on the card from int32 tensors",
         graph_replays=graph_replays)
    entry = _entry(codec, "segment", results, worst,
                   max(r.get("tol", 0.0) for r in results),
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    if clusters is not None:
        entry["clusters"] = clusters
    if by_chunks:
        entry["kernel_ms_by_chunks"] = by_chunks
    entry["options"] = {"window": dict(_window_option(window), bound_by=window["bound_by"])}
    entry["graph_replays"] = sum(len(c["replays"]) for cases in graph_replays.values()
                                 for c in cases)
    return entry


# the segment kernels in one CUDA graph: (n_chunks, seg_start) written into
# the captured count tensors before each replay, without a window and with
# SEG_GRAPH_WINDOW (chunk 0 dead at (4, 1280) and the edge through chunk 1;
# chunks 0-26 dead at (31, 7936), the edge in chunk 27; no pool column left
# to the later rows at (1, 1280))
SEG_GRAPH_COUNTS = ((1, 256), (4, 1024), (0, 0), (31, 7936), (2, 768), (16, 4096),
                    (0, 256), (8, 2304), (31, 8192))
SEG_GRAPH_WINDOW = 1024
SEG_GRAPH_WINDOW_COUNTS = ((4, 1280), (8, 2304), (31, 7936), (1, 1280), (0, 0),
                           (16, 4352), (2, 768), (30, 7936))


def _check_seg_graph(kit, q, li):
    """The segment kernel in one CUDA graph, captured once over two count
    tensors on the card (n_chunks, seg_start) and replayed after each new
    pair is written into them (SEG_GRAPH_COUNTS, then with a sliding
    window SEG_GRAPH_WINDOW_COUNTS): every replay's acc, m and l bit-equal
    to an eager launch at the same counts, and finite.  Returns the cases."""
    import torch
    cases = []
    for window, seq in ((None, SEG_GRAPH_COUNTS), (SEG_GRAPH_WINDOW, SEG_GRAPH_WINDOW_COUNTS)):
        nc_t = torch.full((1,), seq[0][0], dtype=torch.int32, device="cuda")
        ss_t = torch.full((1,), seq[0][1], dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kit.segment(q, nc_t, li, ss_t, window)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            res = kit.segment(q, nc_t, li, ss_t, window)
        replays = []
        for nc, start in seq:
            nc_t.fill_(nc)
            ss_t.fill_(start)
            graph.replay()
            got = [x.clone() for x in res]
            eager = kit.segment(q, nc, li, start, window)
            torch.cuda.synchronize()
            replays.append({"n_chunks": nc, "seg_start": start,
                            "equal_to_eager_launch": all(torch.equal(a, b)
                                                         for a, b in zip(got, eager)),
                            "finite": all(bool(x.isfinite().all()) for x in got)})
            if not (replays[-1]["equal_to_eager_launch"] and replays[-1]["finite"]):
                raise AssertionError(f"the graphed segment kernel at new counts: "
                                     f"{replays[-1]} (window {window})")
        cases.append({"window": window, "li": li, "replays": replays})
        del graph
    return cases


# sliding-window cases of the segment kernels: (n_chunks, seg_start, window);
# query row t*G + g sees the pool columns past seg_start + t - window
SEG_WINDOW_CASES = (
    (30, 7936, 4096),   # chunks 0-14 dead for every row, the edge through chunk 15
    (1, 512, 288),      # the edge through chunk 0; rows of tokens 31 on see no pool column
    (1, 512, 320),      # tokens 63 on see none
    (4, 1280, 320),     # chunks 0-2 dead for every row; the edge through chunk 3
    (4, 1280, 288),     # chunks 0-2 dead; tokens 31 on see no pool column
)
# timed at the longest prompt's last segment: 31 chunks, seg_start 7,936,
# Mistral's window (chunks 0-14 dead for every row)
SEG_WINDOW_TIMED = (31, 7936, 4096)


def _check_seg_windows(kits, g, Hq, Hkv, T, L):
    """The segment kernel with a sliding window at each SEG_WINDOW_CASES
    case, B = 1 and 2 (``kits`` by (B, sparsity)), bf16 q: the rows with a
    live pool column held to the plain version (normalised output within 2
    bf16 ulps of its scale, m within 1e-5 of its scale, l within 1e-4
    relative), the rows with none m = -1e30 in both; every row after
    ``merge_partials`` with a causal self partial within 2 bf16 ulps of the
    plain version's merge; no NaN in any partial; a second launch
    bit-equal.  Then timed at SEG_WINDOW_TIMED, B=1, window on and off in
    turns, beside each's bound (on: the live (row, column) pairs' products
    and the chunks with a live column)."""
    import torch
    from mustafar_tpu_torch.ops.attention import attention_partials, merge_partials
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    D = 128
    G = Hq // Hkv
    results, worst = [], 0.0
    for nc, seg_start, window in SEG_WINDOW_CASES:
        for B in (1, 2):
            kit = kits[(B, 0.7)]
            dev = kit.k_win.device
            qq = torch.randn((B, T, Hq, D), generator=g, device=dev).to(torch.bfloat16)
            k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            li = nc % L
            got = kit.segment(qq, nc, li, seg_start, window)
            again = kit.segment(qq, nc, li, seg_start, window)
            torch.cuda.synchronize()
            want = kit.segment_plain(qq, nc, li, seg_start, window)
            acc, m, l = got
            pa, pm, pl = want
            t = torch.arange(T, device=dev)
            live = seg_start + t - window < nc * 256 - 1            # tokens with a live column
            out, pout = acc[:, live] / l[:, live], pa[:, live] / pl[:, live]
            err = (out - pout).abs().max().item()
            tol = KERNEL_TOL_ULPS * 2.0 ** -8 * pout.abs().max().item()
            m_err = (m[:, live] - pm[:, live]).abs().max().item()
            m_tol = 1e-5 * pm[:, live].abs().max().item()
            l_err = ((l[:, live] - pl[:, live]).abs() / pl[:, live]).max().item()
            dead_m = bool((m[:, ~live] == -1e30).all() and (pm[:, ~live] == -1e30).all())
            p_self = attention_partials(qq, k, v, torch.ones((T, T), dtype=torch.bool,
                                                             device=dev).tril())
            merged = merge_partials([got, p_self])
            merged_want = merge_partials([want, p_self])
            merged_err = (merged - merged_want).abs().max().item()
            merged_tol = KERNEL_TOL_ULPS * 2.0 ** -8 * merged_want.abs().max().item()
            finite = all(bool(x.isfinite().all()) for x in (*got, merged))
            case = {"B": B, "n_chunks": nc, "seg_start": seg_start, "window": window,
                    "li": li, "live_tokens": int(live.sum()),
                    "first_chunk_of_oldest_row": qa.segment_first_chunk(seg_start, 0,
                                                                        window, nc),
                    "max_abs_err": err, "tol": tol, "m_err": m_err, "m_tol": m_tol,
                    "l_rel_err": l_err, "l_tol": 1e-4, "dead_rows_m_neg": dead_m,
                    "merged_max_abs_err": merged_err, "merged_tol": merged_tol,
                    "finite": finite,
                    "second_launch_equal": all(torch.equal(a, b) for a, b in zip(got, again))}
            results.append(case)
            if not (finite and err <= tol and m_err <= m_tol and l_err <= 1e-4 and dead_m
                    and merged_err <= merged_tol and case["second_launch_equal"]):
                raise AssertionError(f"windowed segment kernel disagrees with its plain "
                                     f"version or with itself: {case}")
            worst = max(worst, err / max(tol, 1e-30), m_err / max(m_tol, 1e-30),
                        l_err / 1e-4, merged_err / max(merged_tol, 1e-30))
    nc, seg_start, window = SEG_WINDOW_TIMED
    kit = kits[(1, 0.7)]
    q = torch.randn((1, T, Hq, D), generator=g, device=kit.k_win.device).to(torch.bfloat16)
    for _ in range(3):
        kit.segment(q, nc, 0, seg_start, window)
        kit.segment(q, nc, 0, seg_start)
    torch.cuda.synchronize()
    ms = [cuda_ms(call, 20)[0]
          for call in (lambda: kit.segment(q, nc, 0, seg_start, window),
                       lambda: kit.segment(q, nc, 0, seg_start),
                       lambda: kit.segment(q, nc, 0, seg_start),
                       lambda: kit.segment(q, nc, 0, seg_start, window))]
    plain_ms, _ = cuda_ms(lambda: kit.segment_plain(q, nc, 0, seg_start, window), 3,
                          spin=False)
    BH = Hkv
    first = qa.segment_first_chunk(seg_start, 0, window, nc)
    lows = [seg_start + t - window for t in range(T)]
    live_cols = sum(max(nc * 256 - 1 - max(lo, -1), 0) for lo in lows)

    def bound(cols, chunks):
        flops = 4 * BH * G * cols * D
        nbytes = BH * chunks * kit.chunk_bytes + q.numel() * 2 + T * Hq * (D + 2) * 4
        return nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    on, off = bound(live_cols, nc - first), bound(T * nc * 256, nc)
    turns = in_turns(ms)
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": ("live rows: the output (acc / l) within 2 bf16 ulps of its scale, m "
                    "within 1e-5 of its scale, l within 1e-4 relative; rows with no live "
                    "pool column m = -1e30; every row merged with a self partial within "
                    "2 bf16 ulps"),
            "worst_err_over_tol": worst, "worst_err_over_tol_split": None,
            "timed": {"timed_at": f"B=1, {nc} chunks, seg_start {seg_start}, window "
                                  f"{window} (chunks 0-{first - 1} dead for every row), in "
                                  f"turns on, off, off, on (the least of each pair)",
                      "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
                      "live_chunks": nc - first, "bound_ms": max(on), "bound_ms_off": max(off),
                      "plain_ms": plain_ms},
            "bound_by": "operations" if on[1] >= on[0] else "bytes"}


PACK_NO_LIBRARY = ("no single PyTorch call computes an exact top-k with ties to the "
                   "lower channel plus quantize plus pack (torch.topk orders ties "
                   "arbitrarily)")


def phase_kernel_pack():
    """Kernel 9 against its plain version on the card, bit-equal (rows and
    scales, zero tolerance).  The one-tensor entry (``prune_quant_pack``):
    B*Hkv = 64 and 8 head-chunks of C = 256, bits 8 and 4, keep 40
    (sparsity 0.7), 14 and 128, with injected ties (channel 10 = channel
    90, a row of equal magnitudes, a row of two values), an all-zero row
    and, at 64, the f32 score option; C = 128, 384 and 512 at 8 head-chunks
    (with a score too); the cache's strided case (a [B, T, Hkv, 128] prompt
    slice in, the pool slot's K rows and the scales' K column out).  The
    K+V entry (``prune_quant_pack_kv``, the cache's), each case into pool
    views filled with sentinels that it must leave alone: q8q4, q8 and
    q4q4, K and V keeps apart, in prefill's chunk layout (3 chunks of a
    [8, 840, 8, 128] prompt into pool slots 0-2 of a layer) and a
    compaction's layer layout (4 layers' windows into slot 2 of each); every
    cluster size ``pack_grid`` picks on this card, at the largest even
    head-chunk count up to two an SM that makes it pick that size; and
    the timed calls' own inputs.  Timed L2-flushed beside the byte bound and
    the plain chain: K alone at 64 head-chunks (8 and 4 bits, keep 40; keep
    128, which skips the selection), 8 head-chunks (8 bits); K+V (q8q4) of
    prefill's chunk at B=8 (the main path's call, the kernels line's
    numbers), of the engine's batch-1 pack and of a compaction of 32 layers
    at B=8, the first two beside a launch each for K and V, the last
    beside the 2 x 32 one-tensor launches that packed it before."""
    import torch
    from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    C, D = 256, 128
    fn, kv = pk.prune_quant_pack, pk.prune_quant_pack_kv
    launches0 = (fn.launches, kv.launches)

    def chunk(*lead, C=C):
        x = (0.3 * torch.randn((*lead, C, D), generator=g, device=dev)).to(torch.bfloat16)
        x[..., 10] = x[..., 90]                       # ties across channels
        x[..., 5, :] = 0                              # an all-zero row
        x[..., 7, :] = 0.5                            # a row of equal magnitudes
        x[..., 9, :] = torch.where(torch.arange(D, device=dev) % 2 == 0, 0.25, -0.75)
        return x

    results = []

    def same(label, got, want, **case):
        rows_eq = torch.equal(got[0], want[0])
        sc_eq = torch.equal(got[1].view(torch.int16), want[1].view(torch.int16))
        diff = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        results.append({"case": label, **case, "rows_equal": rows_eq,
                        "scales_equal": sc_eq, "elements_differing": diff})
        if not (rows_eq and sc_eq):
            raise AssertionError(f"prune_quant_pack disagrees with its plain version: "
                                 f"{results[-1]}")

    def check(label, x, keep, bits, score=None, rows_out=None, scales_out=None):
        got = fn(x, keep, bits, score, rows_out=rows_out, scales_out=scales_out)
        torch.cuda.synchronize()
        same(label, got, pk.prune_quant_pack_plain(x, keep, bits, score), keep=keep,
             bits=bits, score=score is not None)

    for BH in (64, 8):
        x = chunk(BH)
        score = torch.rand((BH, C, D), generator=g, device=dev)
        for bits in (8, 4):
            for keep in (40, 14, 128):
                check(f"BH={BH}", x, keep, bits)
            if BH == 64:
                check(f"BH={BH}", x, 40, bits, score)
    for Ci in (128, 384, 512):
        x = chunk(8, C=Ci)
        score = torch.rand((8, Ci, D), generator=g, device=dev)
        for bits in (8, 4):
            check(f"C={Ci}", x, 40, bits)
            check(f"C={Ci}", x, 40, bits, score)
    # the cache's layouts: a prompt slice [B, Hkv, C, D] (strides of
    # [B, T, Hkv, D]) into the pool slot's K rows and the scales' K column
    B, Hkv, T = 8, 8, 512
    k = (0.3 * torch.randn((B, T, Hkv, D), generator=g, device=dev)).to(torch.bfloat16)
    kh = k.transpose(1, 2)[:, :, 256:512]
    pool = torch.zeros((B, Hkv, 192, D), dtype=torch.int16, device=dev)
    sc = torch.zeros((B, Hkv, 2, D), dtype=torch.bfloat16, device=dev)
    check("strided", kh, 40, 8, rows_out=pool[:, :, :128], scales_out=sc[:, :, 0])
    if not ((pool[:, :, 128:] == 0).all() and (sc[:, :, 1] == 0).all()):
        raise AssertionError("prune_quant_pack wrote outside its output views")

    def kv_views(pool, scales, at, KR):
        """(K rows, K scales), (V rows, V scales) of pool[at] / scales[at]."""
        return ((pool[at][..., :KR, :], scales[at][..., 0, :]),
                (pool[at][..., KR:, :], scales[at][..., 1, :]))

    def check_kv(label, k, v, pool, scales, at, keeps, bits, scores=(None, None), **case):
        """K+V into pool[at] / scales[at] (K rows, then V rows), each ranked
        by its score if given; the rest of pool and scales must keep their
        sentinels."""
        KR = C * bits[0] // 16
        pool.fill_(7)
        scales.fill_(3.0)
        k_out, v_out = kv_views(pool, scales, at, KR)
        kv(k, v, *keeps, *bits, k_out=k_out, v_out=v_out, k_score=scores[0],
           v_score=scores[1])
        torch.cuda.synchronize()
        for name, x, keep, nb, out, sc in (("K", k, keeps[0], bits[0], k_out, scores[0]),
                                           ("V", v, keeps[1], bits[1], v_out, scores[1])):
            same(f"{label} {name}", out, pk.prune_quant_pack_plain(x, keep, nb, sc),
                 keep=keep, bits=nb, score=sc is not None, **case)
        pool[at] = 7
        scales[at] = 3.0
        if not ((pool == 7).all() and (scales == 3.0).all()):
            raise AssertionError(f"prune_quant_pack_kv ({label}) wrote outside its views")

    def kv_pool(*lead, rows=192):
        return (torch.empty((*lead, rows, D), dtype=torch.int16, device=dev),
                torch.empty((*lead, 2, D), dtype=torch.bfloat16, device=dev))

    for codec, keeps in (("q8q4", (40, 14)), ("q8", (40, 77)), ("q4q4", (14, 40))):
        bits = QUANT_BITS[codec]
        rows = C * (bits[0] + bits[1]) // 16
        # prefill: the prompt's 3 chunks of layer 1 into pool slots 0-2
        # (a [B, T, Hkv, D] prompt seen as [B, Hkv, T, D], as the cache sees it)
        kp, vp = (chunk(B, Hkv, C=3 * C + 72).transpose(1, 2).contiguous().transpose(1, 2)
                  [:, :, :3 * C].unflatten(2, (3, C)).movedim(2, 0) for _ in range(2))
        check_kv(f"{codec} prefill", kp, vp, *kv_pool(2, 5, B, Hkv, rows=rows),
                 (1, slice(0, 3)), keeps, bits)
        # compaction: 4 layers' windows (r + C = 288 tokens) into slot 2
        kw, vw = (chunk(4, B, Hkv, C=288)[..., :C, :] for _ in range(2))
        check_kv(f"{codec} compaction", kw, vw, *kv_pool(4, 5, B, Hkv, rows=rows),
                 (slice(None), 2), keeps, bits)
        # the Opa policies: a score on one operand (V for KT_MAG_VT_OPA, K
        # for KT_OPA_VT_MAG) or both; the other keyed by |x| in the same launch
        for scored in ((False, True), (True, False), (True, True)):
            sk, sv = (torch.rand(x.shape, generator=g, device=dev) if on else None
                      for x, on in zip((kp, vp), scored))
            check_kv(f"{codec} prefill scored", kp, vp, *kv_pool(2, 5, B, Hkv, rows=rows),
                     (1, slice(0, 3)), keeps, bits, (sk, sv), scored=scored)
            sk, sv = (torch.rand(x.shape, generator=g, device=dev) if on else None
                      for x, on in zip((kw, vw), scored))
            check_kv(f"{codec} compaction scored", kw, vw,
                     *kv_pool(4, 5, B, Hkv, rows=rows), (slice(None), 2), keeps, bits,
                     (sk, sv), scored=scored)

    index = torch.cuda.current_device()

    def capacity(cluster, threads):
        return pk.max_clusters(index, C, cluster, threads, False)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # every cluster size the grid rule picks here (C = 256), K+V (q8q4) of
    # the largest even head-chunk count up to 2 x SMs that picks it
    picks = {}
    for n in range(2, 2 * sms + 1, 2):
        picks[pk.pack_grid(n, C, sms=sms, capacity=capacity)] = n
    clusters = {}
    for (cluster, threads), n in sorted(picks.items()):
        check_kv(f"cluster {cluster}", chunk(n // 2), chunk(n // 2), *kv_pool(2, n // 2), 1,
                 (40, 14), (8, 4), head_chunks=n, cluster=cluster)
        clusters[cluster] = {"head_chunks": n, "threads": threads,
                             "max_active_clusters": capacity(cluster, threads)}

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)

    def timed_call(call, plain, nbytes, n_hc, plain_reps=5):
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        kernel_ms, behind = cuda_ms(call, 50, flush=flush_buf.zero_)
        plain_ms, _ = cuda_ms(plain, plain_reps, flush=flush_buf.zero_, spin=False)
        cluster, threads = pk.pack_grid(n_hc, C, sms=sms, capacity=capacity)
        return {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bytes": nbytes,
                "head_chunks": n_hc, "cluster": cluster, "threads": threads,
                "max_active_clusters": capacity(cluster, threads),
                "host_behind": behind, "wrapper_host_us": host_us(call, 50)}

    def chunk_bytes(bits):
        return C * D * 2 + (C * bits // 16) * D * 2 + D * 2

    timed = {}
    # one tensor; keep 128 skips the selection: the difference is its share
    for BH, bits, keep in ((64, 8, 40), (64, 4, 40), (8, 8, 40), (64, 8, 128)):
        x = chunk(BH)
        timed[f"BH{BH}_bits{bits}" + ("" if keep == 40 else f"_keep{keep}")] = timed_call(
            lambda x=x, keep=keep, bits=bits: fn(x, keep, bits),
            lambda x=x, keep=keep, bits=bits: pk.prune_quant_pack_plain(x, keep, bits),
            BH * chunk_bytes(bits), BH)
    # K+V (q8q4, keep 40 each) in one launch into pool views, held against
    # the plain version first: prefill's chunk at B=8, the engine's batch-1
    # pack, and a compaction of 32 layers at B=8 (every layer's window into
    # its pool slot)
    L = 32
    cases = (("kv_BH64", (B, Hkv), C, 1), ("kv_BH8", (1, Hkv), C, 1),
             ("kv_compaction_L32", (L, B, Hkv), 288, (slice(None), 1)))
    for label, lead, W, at in cases:
        k, v = (chunk(*lead, C=W)[..., :C, :] for _ in range(2))
        pool, scales = kv_pool(*((L, 2, B, Hkv) if len(lead) == 3 else (2, *lead)))
        check_kv(label, k, v, pool, scales, at, (40, 40), (8, 4))
        outs = kv_views(pool, scales, at, 128)
        n = k.numel() // (C * D)
        timed[label] = timed_call(
            lambda k=k, v=v, outs=outs: kv(k, v, 40, 40, 8, 4, k_out=outs[0],
                                           v_out=outs[1]),
            lambda k=k, v=v: (pk.prune_quant_pack_plain(k, 40, 8),
                              pk.prune_quant_pack_plain(v, 40, 4)),
            n * (chunk_bytes(8) + chunk_bytes(4)), 2 * n, plain_reps=2 if n > 64 else 5)
        if len(lead) == 2:
            timed[label]["two_launches_ms"] = cuda_ms(
                lambda k=k, v=v: (fn(k, 40, 8), fn(v, 40, 4)), 50, flush=flush_buf.zero_)[0]
            if label == "kv_BH64":
                # V ranked by a score (KT_MAG_VT_OPA's pack) and not, in turns
                sv = torch.rand(v.shape, generator=g, device=dev)
                check_kv("kv_BH64 V scored", k, v, pool, scales, at, (40, 40), (8, 4),
                         (None, sv))
                timed["kv_BH64_v_score"] = [cuda_ms(call, 50, flush=flush_buf.zero_)[0]
                                            for call in (
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1],
                               v_score=sv),
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1]),
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1]),
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1],
                               v_score=sv))]
            continue

        def per_layer(k=k, v=v, outs=outs):
            for li in range(L):
                fn(k[li], 40, 8, rows_out=outs[0][0][li], scales_out=outs[0][1][li])
                fn(v[li], 40, 4, rows_out=outs[1][0][li], scales_out=outs[1][1][li])

        per_layer()
        torch.cuda.synchronize()
        # 64 wrapper calls take longer on the host than the default spin
        ms, behind = cuda_ms(per_layer, 20, flush=flush_buf.zero_,
                             spin_cycles=20 * SPIN_CYCLES)
        timed[label].update(per_layer_launches_ms=ms, per_layer_host_behind=behind,
                            per_layer_host_us=host_us(per_layer, 10))
    fn.launches, kv.launches = launches0                   # comparisons do not count
    emit("kernel_pack", C=C, cases=results, timed=timed, clusters_checked=clusters,
         library_ms=None, library_note=PACK_NO_LIBRARY)
    t = timed["kv_BH64"]
    entry = _entry("q8q4", "pack", results, 0.0, "bit-equal (rows and scales)",
                   t["kernel_ms"], t["plain_ms"], t["bound_ms"], 0.0)
    entry.update(max_abs_err=0.0,
                 timed_at="B=8, Hkv=8, C=256 (prefill's chunk of a layer): K at 8 bits "
                          "and V at 4, keep 40, one launch",
                 timed_other={key: {f: timed[key][f] for f in ("kernel_ms", "bound_ms",
                                                               "plain_ms")}
                              for key in ("BH64_bits8", "kv_BH8", "kv_compaction_L32")},
                 library_note=PACK_NO_LIBRARY)
    on_off = timed["kv_BH64_v_score"]
    entry["options"] = {"score": {
        "max_abs_err": 0.0, "tol": "bit-equal (rows and scales)",
        "ms": (on_off[0] + on_off[3]) / 2, "ms_off": (on_off[1] + on_off[2]) / 2,
        "launches": None,
        "timed_at": "as ms with V ranked by an f32 score and K by |x| in the same "
                    "launch, in turns on, off, off, on"}}
    return entry


# every Llama-3-8B projection (wk and wv share 4096 -> 1024, w_gate and w_up
# 4096 -> 14336) and the fused wqkv and w_gateup
W4_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024), "w_gate_up": (4096, 14336),
             "w_down": (14336, 4096), "wqkv": (4096, 6144), "w_gateup": (4096, 28672)}
W4_NO_LIBRARY = ("no PyTorch call takes these carriers: torch._weight_int4pack_mm "
                 "wants its own tile layout and zero points")


def phase_kernel_w4():
    """The W4 kernel against its plain version on the card at every
    projection shape of the 8B (and the fused ones), T = 8 and 32, layer 1
    of 2-layer stacks of random carriers (every int16 is a valid code set)
    and bf16 scales 0.001-0.021; also T = 1, 13, 100, 128 and f32 x at one
    shape.  Each timed L2-flushed (a layer's weights are read once a
    step) beside its byte bound, the plain version, the wrapper's host
    time, the W8 ``proj`` and a bf16 ``torch.matmul`` at the same shape."""
    import torch
    from mustafar_tpu_torch.models.quant import proj
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    launches0 = w4.w4_matmul.launches
    results, worst, timed = [], 0.0, {}

    def check(label, x, c, s, T):
        got = w4.w4_matmul(x, c[1], s[1])
        again = w4.w4_matmul(x, c[1], s[1])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"w4_matmul: a second launch on the same inputs gave "
                                 f"other bits ({label}, T={T})")
        want = w4.w4_matmul_plain(x, c[1], s[1])
        err = (got.float() - want.float()).abs().max().item()
        # f32 sums of the same exact products in another order; each rounds
        # once to the output's type: 2 bf16 ulps of the output's scale
        tol = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().max().item()
        results.append({"shape": label, "T": T, "x_dtype": str(x.dtype).split(".")[-1],
                        "max_abs_err": err, "tol": tol})
        if not (got.isfinite().all() and got.dtype == x.dtype and err <= tol):
            raise AssertionError(f"w4_matmul disagrees with its plain version: {results[-1]}")
        return err / max(tol, 1e-30)

    for label, (din, dout) in W4_SHAPES.items():
        c = torch.randint(-32768, 32768, (2, din // 4, dout), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int16)
        s = (0.001 + 0.02 * torch.rand((2, din // 128, dout), generator=g,
                                       device=dev)).to(torch.bfloat16)
        ts = (8, 32) + ((1, 13, 100, 128) if label == "wq_wo" else ())
        for T in ts:
            x = torch.randn((T, din), generator=g, device=dev).to(torch.bfloat16)
            worst = max(worst, check(label, x, c, s, T))
            if label == "wq_wo" and T == 13:
                worst = max(worst, check(label, x.float(), c, s, T))
                if not refuses_short_workspace(lambda: w4.w4_matmul(x, c[1], s[1])):
                    raise AssertionError("w4_matmul did not refuse a short workspace")
        # W8 and bf16 weights of the same shape, for context
        w8 = {"w": torch.randint(-127, 128, (din, dout), generator=g, device=dev,
                                 dtype=torch.int32).to(torch.int8),
              "w_scale": torch.rand((dout,), generator=g, device=dev) * 0.01}
        wbf = torch.randn((din, dout), generator=g, device=dev).to(torch.bfloat16)
        for T in (8, 32):
            x = torch.randn((T, din), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(3):
                w4.w4_matmul(x, c[1], s[1])
                proj(x, w8, "w")
            torch.cuda.synchronize()
            kernel_ms, behind = cuda_ms(lambda: w4.w4_matmul(x, c[1], s[1]), 30,
                                        flush=flush_buf.zero_)
            plain_ms, _ = cuda_ms(lambda: w4.w4_matmul_plain(x, c[1], s[1]), 3,
                                  flush=flush_buf.zero_, spin=False)
            w8_ms, _ = cuda_ms(lambda: proj(x, w8, "w"), 10, flush=flush_buf.zero_)
            bf16_ms, _ = cuda_ms(lambda: x @ wbf, 10, flush=flush_buf.zero_)
            nbytes = din * dout // 2 + din // 128 * dout * 2 + T * (din + dout) * 2
            flops = 2 * T * din * dout                      # bf16 tensor-core products
            bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
            flops_ms = flops / H100_BF16_FLOPS * 1e3
            part = w4.partition(T, din, dout, w4._sms(torch.cuda.current_device()))
            timed[f"{label}_T{T}"] = {
                "din": din, "dout": dout, "T": T, "kernel_ms": kernel_ms,
                "bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms,
                "flops_ms": flops_ms, "share_of_bound": bytes_ms / kernel_ms,
                "bytes": nbytes, "plain_ms": plain_ms, "w8_proj_ms": w8_ms,
                "bf16_matmul_ms": bf16_ms, "host_behind": behind,
                "wrapper_host_us": host_us(lambda: w4.w4_matmul(x, c[1], s[1]), 50),
                "ctas": part.ctas, "units": part.units}
        del c, s, w8, wbf
    w4.w4_matmul.launches = launches0                    # comparisons do not count
    emit("kernel_w4", cases=results, worst_err_over_tol=worst, timed=timed,
         library_ms=None, library_note=W4_NO_LIBRARY)
    # the kernels line: the decode shape of the largest projection (w_gate / w_up, T=8)
    t = timed["w_gate_up_T8"]
    entry = _entry("w4", "matmul", results, worst, max(r["tol"] for r in results),
                   t["kernel_ms"], t["plain_ms"], t["bytes_ms"], t["flops_ms"])
    entry.update(timed_at="4096 x 14336, T=8", library_note=W4_NO_LIBRARY)
    return entry


def _sdpa_ms(q, k, v, pos, flush, window=None):
    """The library call for the same function: ``scaled_dot_product_attention``
    with GQA and a boolean mask of each slot's rows [0, pos[b]] (with a
    sliding ``window``, the band (pos[b] - window, pos[b]]); returns (its
    device ms, the backend PyTorch picked, its output)."""
    import torch
    import torch.nn.functional as F
    B, S = k.shape[:2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows = torch.arange(S, device=q.device)[None, :]
    mask = rows <= pos[:, None]
    if window is not None:
        mask &= rows > pos[:, None] - window
    mask = mask[:, None, None, :]
    backend = "unknown"
    if hasattr(torch, "_fused_sdp_choice"):
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, mask, 0.0, False,
                                                     enable_gqa=True)).name

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    out = call()
    torch.cuda.synchronize()
    return cuda_ms(call, 20, flush=flush)[0], backend, out.transpose(1, 2)


def phase_kernel_dense():
    """The dense flash-decode kernel against its plain version: uniform at
    ``serve_dense``'s shape (B=8, S=1,312, pos 599, Hkv=8, G=4) and per slot
    at ``serve_cb``'s cache (S=8,448) with a slot at pos 8,000, an idle slot
    and six of 45-1,499; also G = 1, 2, 8 and f32 q; held to the TPU-order
    plain version at 2 bf16 ulps of each slot's largest output and to the
    split plain version (the kernel's own arithmetic) by ``split_gate``;
    short scratch must be refused.  Timed
    L2-flushed beside its byte bound, the plain version and
    ``scaled_dot_product_attention`` (GQA, boolean mask), both cases."""
    import torch
    from mustafar_tpu_torch.ops.kernels import dense_decode as dd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    fn = dd.flash_decode_attention
    launches0 = fn.launches
    B, Hkv, D = 8, 8, 128
    shapes, results, worst, worst_split, norm_worst = {}, [], 0.0, 0.0, 0.0
    cases = {"uniform": (1312, 599),
             "per_slot": (8448, [8000, 1210, 300, -1, 640, 1499, 45, 950])}
    for label, (S, pos) in cases.items():
        k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        kpos = (torch.tensor(pos, dtype=torch.int32, device=dev) if isinstance(pos, list)
                else pos)
        slot_pos = kpos if torch.is_tensor(kpos) else torch.full((B,), pos, device=dev)
        for G in (4, 1, 2, 8):
            qb = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
            for q in ((qb, qb.float()) if G == 4 else (qb,)):
                got = fn(q, k, v, kpos)
                torch.cuda.synchronize()
                want = dd.flash_decode_attention_plain(q, k, v, kpos)
                # each slot held to 2 bf16 ulps of its own output's scale
                dims = (1, 2, 3)
                errs = (got.float() - want.float()).abs().amax(dim=dims)
                tols = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().amax(dim=dims)
                live = slot_pos >= 0
                ratio = (errs[live] / tols[live].clamp_min(1e-30)).max().item()
                idle_zero = bool((got[~live] == 0).all())
                results.append({"case": label, "G": G, "q_dtype": str(q.dtype).split(".")[-1],
                                "max_abs_err": errs.max().item(),
                                "worst_err_over_tol": ratio, "idle_slots_zero": idle_zero})
                if not (got.isfinite().all() and ratio <= 1.0 and idle_zero):
                    raise AssertionError(f"dense decode kernel disagrees with its plain "
                                         f"version: {results[-1]}")
                worst = max(worst, ratio)
                ratio = split_gate(got, dd.flash_decode_attention_split_plain(
                    q.float(), k, v, kpos), live)
                results[-1]["worst_err_over_tol_split"] = ratio
                if not ratio <= 1.0:
                    raise AssertionError(f"dense decode kernel disagrees with its split "
                                         f"plain version: {results[-1]}")
                worst_split = max(worst_split, ratio)
                norm_worst = max(norm_worst, _check_norm(fn, dd, q, k, v, kpos, got,
                                                         results[-1]))
        q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
        if not refuses_short_scratch(lambda: fn(q, k, v, kpos)):
            raise AssertionError(f"dense decode kernel took scratch shorter than its "
                                 f"grid needs ({label})")
        for _ in range(5):
            fn(q, k, v, kpos)
        torch.cuda.synchronize()
        kernel_ms, behind = cuda_ms(lambda: fn(q, k, v, kpos), 50, flush=flush_buf.zero_)
        # the final (m, l) on and off, in turns
        norm_ms = [cuda_ms(call, 50, flush=flush_buf.zero_)[0]
                   for call in (lambda: fn(q, k, v, kpos, return_norm=True),
                                lambda: fn(q, k, v, kpos), lambda: fn(q, k, v, kpos),
                                lambda: fn(q, k, v, kpos, return_norm=True))]
        plain_ms, _ = cuda_ms(lambda: dd.flash_decode_attention_plain(q, k, v, kpos), 3,
                              flush=flush_buf.zero_, spin=False)
        lib_ms, backend, lib_out = _sdpa_ms(q, k, v, slot_pos, flush_buf.zero_)
        live = slot_pos >= 0
        lib_err = (lib_out[live].float() - fn(q, k, v, kpos)[live].float()).abs().max().item()
        n_tok = int((slot_pos + 1).clamp(min=0).sum())
        nbytes = n_tok * Hkv * D * 2 * 2 + 2 * q.numel() * 2 + (4 * B if label == "per_slot" else 0)
        flops = n_tok * Hkv * 4 * D * 2 * 2                 # scores + p.v, G = 4
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        flops_ms = flops / H100_F32_FLOPS * 1e3
        shapes[label] = {"S": S, "pos": pos, "kernel_ms": kernel_ms, "host_behind": behind,
                         "bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms,
                         "flops_ms": flops_ms, "bytes": nbytes, "flops": flops, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "library_backend": backend,
                         "library_max_abs_diff": lib_err, "tile": dd.decode_tile(S),
                         "split_len": dd.split_len(dd._covered(kpos, S), B * Hkv,
                                                   dd._sms(q.device)),
                         "wrapper_host_us": host_us(lambda: fn(q, k, v, kpos), 50),
                         "return_norm_ms": {"on": (norm_ms[0] + norm_ms[3]) / 2,
                                            "off": (norm_ms[1] + norm_ms[2]) / 2,
                                            "in_turns": norm_ms}}
        del k, v
    window = _dense_windows(fn, dd, g, dev, flush_buf)
    fn.launches = launches0                                # comparisons do not count
    emit("kernel_dense", B=B, Hkv=Hkv, cases=results, worst_err_over_tol=worst,
         worst_err_over_tol_split=worst_split, return_norm_worst_err_over_tol=norm_worst,
         timed=shapes, window=window)
    t = shapes["uniform"]
    entry = _entry("dense", "decode", results, worst,
                   "per slot: 2 bf16 ulps of the slot's largest output", t["kernel_ms"],
                   t["plain_ms"], t["bytes_ms"], t["flops_ms"])
    p = shapes["per_slot"]
    entry.update(timed_at="B=8, S=1312, pos 599, Hkv=8, G=4", library_ms=t["library_ms"],
                 library_note=f"scaled_dot_product_attention, GQA, boolean mask "
                              f"({t['library_backend']} backend)",
                 worst_err_over_tol_split=worst_split, tol_split=SPLIT_TOL_NOTE,
                 per_slot={"timed_at": "B=8, S=8448, pos 8000 / 1210 / 300 / -1 / 640 / "
                                       "1499 / 45 / 950, Hkv=8, G=4",
                           **{k: p[k] for k in ("kernel_ms", "bound_ms", "plain_ms",
                                                "library_ms")}})
    entry["options"] = {"return_norm": {
        "max_abs_err_m": max(r["m_max_abs_err"] for r in results),
        "max_rel_err_l": max(r["l_max_rel_err"] for r in results),
        "tol": NORM_TOL_NOTE, "worst_err_over_tol": norm_worst,
        "ms": t["return_norm_ms"]["on"], "ms_off": t["return_norm_ms"]["off"],
        "per_slot_ms": p["return_norm_ms"]["on"], "per_slot_ms_off": p["return_norm_ms"]["off"],
        "launches": None, "timed_at": "as ms, in turns on, off, off, on"},
        "window": _window_option(window)}
    return entry


# kernel 4's sliding-window cases: serve_swa's cache (B=4, 8 kv heads, G=4,
# S=4,928) at pos 4,500 with Mistral's 4,096 (first live row 405, inside a
# split) and 3,989 (512, a split boundary); serve_cb's per-slot cache (B=8,
# S=8,448) with 4,096 (the long slot cut) and 1,000 (four slots cut)
DENSE_WINDOWS = (("uniform", 4, 4928, 4500, 4096), ("uniform", 4, 4928, 4500, 3989),
                 ("per_slot", 8, 8448, [8000, 1210, 300, -1, 640, 1499, 45, 950], 4096),
                 ("per_slot", 8, 8448, [8000, 1210, 300, -1, 640, 1499, 45, 950], 1000))


def _dense_windows(fn, dd, g, dev, flush_buf):
    """Kernel 4 with a sliding window (DENSE_WINDOWS; G = 4 at bf16 and f32
    q, G = 1 and 8 at the first case): each slot held to the TPU-order plain
    version at 2 bf16 ulps of its scale and to the split plain version by
    ``split_gate``, its (m, l) by ``_check_norm``, an idle slot 0.  Timed at
    the first case with the window on and off, in turns, beside each's byte
    bound (the rows each attends), the plain version and
    ``scaled_dot_product_attention`` with the band as its mask."""
    import torch
    Hkv, D = 8, 128
    results, worst, worst_split, timed = [], 0.0, 0.0, None
    for i, (label, B, S, pos, window) in enumerate(DENSE_WINDOWS):
        k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        kpos = torch.tensor(pos, dtype=torch.int32, device=dev) if label == "per_slot" else pos
        slot_pos = kpos if torch.is_tensor(kpos) else torch.full((B,), pos, device=dev)
        live = slot_pos >= 0
        dims = (1, 2, 3)
        for G in ((4, 1, 8) if i == 0 else (4,)):
            qb = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
            for q in ((qb, qb.float()) if G == 4 else (qb,)):
                got = fn(q, k, v, kpos, window=window)
                torch.cuda.synchronize()
                want = dd.flash_decode_attention_plain(q, k, v, kpos, window=window)
                errs = (got.float() - want.float()).abs().amax(dim=dims)
                tols = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().amax(dim=dims)
                ratio = (errs[live] / tols[live].clamp_min(1e-30)).max().item()
                split = split_gate(got, dd.flash_decode_attention_split_plain(
                    q.float(), k, v, kpos, window=window), live)
                case = {"case": label, "S": S, "pos": pos, "window": window, "G": G,
                        "q_dtype": str(q.dtype).split(".")[-1],
                        "max_abs_err": errs.max().item(), "worst_err_over_tol": ratio,
                        "worst_err_over_tol_split": split,
                        "idle_slots_zero": bool((got[~live] == 0).all())}
                results.append(case)
                if not (got.isfinite().all() and ratio <= 1.0 and split <= 1.0
                        and case["idle_slots_zero"]):
                    raise AssertionError(f"dense decode kernel with a window disagrees with "
                                         f"its plain versions: {case}")
                _check_norm(fn, dd, q, k, v, kpos, got, case, window)
                worst, worst_split = max(worst, ratio), max(worst_split, split)
        if i == 0:
            q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(5):
                fn(q, k, v, kpos, window=window)
                fn(q, k, v, kpos)
            torch.cuda.synchronize()
            ms = [cuda_ms(call, 50, flush=flush_buf.zero_)[0]
                  for call in (lambda: fn(q, k, v, kpos, window=window),
                               lambda: fn(q, k, v, kpos), lambda: fn(q, k, v, kpos),
                               lambda: fn(q, k, v, kpos, window=window))]
            plain_ms, _ = cuda_ms(lambda: dd.flash_decode_attention_plain(
                q, k, v, kpos, window=window), 3, flush=flush_buf.zero_, spin=False)
            lib_ms, backend, lib_out = _sdpa_ms(q, k, v, slot_pos, flush_buf.zero_, window)
            lib_off_ms = _sdpa_ms(q, k, v, slot_pos, flush_buf.zero_)[0]
            lib_err = (lib_out.float() - fn(q, k, v, kpos, window=window).float()
                       ).abs().max().item()

            def bound(rows):
                nbytes = rows * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                flops = rows * Hkv * 4 * D * 2 * 2
                return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
            turns = in_turns(ms)
            timed = {"timed_at": f"B={B}, S={S}, pos {pos}, Hkv={Hkv}, G=4, window {window} "
                                 f"(rows {pos - window + 1}-{pos}), in turns on, off, off, on "
                                 f"(the least of each pair)",
                     "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
                     "bound_ms": bound(B * window), "bound_ms_off": bound(B * (pos + 1)),
                     "plain_ms": plain_ms, "library_ms": lib_ms, "library_ms_off": lib_off_ms,
                     "library_backend": backend, "library_max_abs_diff": lib_err}
        del k, v
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": "per slot: 2 bf16 ulps of the slot's largest output (TPU order); "
                   + SPLIT_TOL_NOTE,
            "worst_err_over_tol": worst, "worst_err_over_tol_split": worst_split,
            "timed": timed}


NORM_TOL = 2.0 ** -18
NORM_TOL_NOTE = ("m within 2^-18 absolute, l within 2^-18 of l (a sum of up to 128 "
                 "exps a split, >= 1 for a live slot), of the split plain version's")


def _check_norm(fn, dd, q, k, v, kpos, got, case, window=None):
    """Kernel 4's final (m, l) (``return_norm``) against its split plain
    version's (NORM_TOL_NOTE; an idle slot -1e30 and 0 exactly) and its
    output bit-equal to ``got``, the call without the option (with the
    sliding ``window``, if given, in both).  Records into ``case`` and
    returns the worst error over the tolerance."""
    import torch
    out, m, l = fn(q, k, v, kpos, window=window, return_norm=True)
    torch.cuda.synchronize()
    _, wm, wl = dd.flash_decode_attention_split_plain(q.float(), k, v, kpos,
                                                       return_norm=True, window=window)
    m_err = (m - wm).abs().max().item()
    l_err = ((l - wl).abs() / wl.clamp_min(1.0)).max().item()
    case.update(m_max_abs_err=m_err, l_max_rel_err=l_err,
                norm_out_equal_without=bool(torch.equal(out, got)))
    if not (case["norm_out_equal_without"] and m_err <= NORM_TOL and l_err <= NORM_TOL):
        raise AssertionError(f"dense decode kernel's (m, l) disagree with its split plain "
                             f"version's, or change the output: {case}")
    return max(m_err, l_err) / NORM_TOL


# ---------------------------------------------------------------------------
# The archived generations: v1-v3 over split pools (TPU kernels 10-13), v4-v6
# over the fused stream (kernels 14-16)
# ---------------------------------------------------------------------------

ARCHIVE_KINDS = ("key_scores", "value_combine", "v2", "v3", "v4", "v5", "v6")
ARCHIVE_WINDOWS = (300, 600)     # v6's sliding windows, checked at 5 chunks
ARCHIVE_CASES = ((0, 44), (1, 288), (2, 1), (5, 288), (5, 0))   # (n_chunks, win_len)
SCORES_RTOL = 1e-5   # kernel 10: f32 sums of 128 exact bf16 products in two orders


def _archive_pools(x, fmt):
    """Dense chunks x [2 (K, V), BH, mc, 256, 128] pruned and packed on the
    card: "head" ((k_segs, k_bmp), (v_segs, v_bmp)) head-major for v1 and
    v2, "chunk" the chunk-major copy for v3, "stream" the same chunks as
    kernel 6's fused pool [1, mc, BH, KR + VR, 128]."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    BH = x.shape[1]
    segs, bmp = sf.prune_and_encode_chunk(x, fmt)     # [2, BH, mc, R_i | 8, 128]
    head = tuple(([s[st].reshape(BH, -1, 128) for s in segs], bmp[st].reshape(BH, -1, 128))
                 for st in range(2))
    chunk = tuple(([s[st].transpose(0, 1).contiguous() for s in segs],
                   bmp[st].transpose(0, 1).contiguous()) for st in range(2))
    rows = sf.prune_and_encode_stream(x, fmt)         # [2, BH, mc, SR, 128]
    stream = torch.cat([rows[0], rows[1]], dim=-2).transpose(0, 1).contiguous()[None]
    return {"head": head, "chunk": chunk, "stream": stream}


def _archive_calls(pools, q, kw, vw, nc, wl, fmt, mc):
    """The generations' wrappers (v1-v6 and kernel 6) on one set of pools
    and windows [B, W, Hkv, 128], and their plain versions; v4-v6 read the
    stream pool's layer view ``pools["stream"][0]``."""
    from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    (ks, kb), (vs, vb) = pools["head"]
    (cks, ckb), (cvs, cvb) = pools["chunk"]
    B, W, Hkv, D = kw.shape
    kw6 = kw.permute(0, 2, 1, 3).reshape(1, B * Hkv, W, D).contiguous()
    vw6 = vw.permute(0, 2, 1, 3).reshape(1, B * Hkv, W, D).contiguous()
    head = (ks, kb, vs, vb, kw, vw, nc, wl, fmt, fmt, mc)
    chunk = (cks, ckb, cvs, cvb, kw, vw, nc, wl, fmt, fmt, mc)
    k6 = (pools["stream"], kw6, vw6, nc, wl, 0, fmt, fmt)
    st = (pools["stream"][0], kw, vw, nc, wl, fmt, fmt, mc)
    return {
        "v1": (lambda: sar.sparse_decode_attention(q, *head),
               lambda: sar.sparse_decode_attention_plain(q, *head)),
        "v2": (lambda: sar.fused_sparse_decode_attention(q, *head),
               lambda: sar.fused_sparse_decode_attention_plain(q, *head)),
        "v3": (lambda: sar.fused_sparse_decode_attention_v3(q, *chunk),
               lambda: sar.fused_sparse_decode_attention_v3_plain(q, *chunk)),
        "v4": (lambda: sar.fused_sparse_decode_attention_v4(q, *st),
               lambda: sar.fused_sparse_decode_attention_v4_plain(q, *st)),
        "v5": (lambda: sar.fused_sparse_decode_attention_v5(q, *st),
               lambda: sar.fused_sparse_decode_attention_v5_plain(q, *st)),
        "v6": (lambda: sar.fused_sparse_decode_attention_v6(q, *st),
               lambda: sar.fused_sparse_decode_attention_v6_plain(q, *st)),
        "kernel6": (lambda: ska.fused_sparse_decode_attention(q, *k6),
                    lambda: ska.fused_sparse_decode_attention_plain(q, *k6)),
    }


# (n_chunks, win_len) written into the count tensors of one CUDA graph of
# kernels 12 and 13 (mc=5, W=288): a new window length, a new chunk, no
# window, no chunk, nothing to attend, the full pool
ARCHIVE_GRAPH_COUNTS = ((1, 288), (1, 95), (2, 1), (0, 44), (5, 0), (0, 0), (3, 200),
                        (0, 288), (5, 288))


def _archive_split_plains(pools, q, kw, vw, nc, wl, fmt, mc):
    """Kernels 12 and 13's split plain versions (their own arithmetic) on
    ``_archive_calls``'s inputs, f32 q (the kernels' bf16 q, exactly): the
    f32 result that ``split_gate`` rounds."""
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    (ks, kb), (vs, vb) = pools["head"]
    (cks, ckb), (cvs, cvb) = pools["chunk"]
    qf = q.float()
    return {"v2": lambda: sar.fused_sparse_decode_attention_split_plain(
                qf, ks, kb, vs, vb, kw, vw, nc, wl, fmt, fmt, mc),
            "v3": lambda: sar.fused_sparse_decode_attention_v3_split_plain(
                qf, cks, ckb, cvs, cvb, kw, vw, nc, wl, fmt, fmt, mc)}


def _archive_graph_replays(call):
    """``call(n_chunks, win_len)`` (kernel 12 or 13's wrapper) in one CUDA
    graph, captured over two count tensors on the card and replayed after
    each pair of ``ARCHIVE_GRAPH_COUNTS`` is written into them: every
    replay's output must be an eager launch's at the same counts, bit for
    bit.  Returns the replays."""
    import torch
    nc_t = torch.full((1,), ARCHIVE_GRAPH_COUNTS[0][0], dtype=torch.int32, device="cuda")
    wl_t = torch.full((1,), ARCHIVE_GRAPH_COUNTS[0][1], dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(nc_t, wl_t)                               # scratch for this stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        res = call(nc_t, wl_t)
    replays = []
    for nc, wl in ARCHIVE_GRAPH_COUNTS:
        nc_t.fill_(nc)
        wl_t.fill_(wl)
        graph.replay()
        got = res.clone()
        eager = call(nc, wl)
        torch.cuda.synchronize()
        replays.append({"n_chunks": nc, "win_len": wl,
                        "equal_to_eager_launch": bool(torch.equal(got, eager))})
        if not (replays[-1]["equal_to_eager_launch"] and bool(got.isfinite().all())):
            raise AssertionError(f"the graphed archive kernel at new counts: {replays[-1]}")
    del graph
    return replays


def _check(results, worst, kind, got, want, tol, **case):
    """Record one kernel-against-plain comparison; raise past ``tol``."""
    err = (got.float() - want.float()).abs().max().item()
    results.append({"kernel": kind, **case, "max_abs_err": err, "tol": tol})
    if not (got.isfinite().all() and err <= tol):
        raise AssertionError(f"archive kernel disagrees with its plain version: "
                             f"{results[-1]}")
    worst[kind] = max(worst[kind], err / max(tol, 1e-30))


def _check_partials(results, worst, got, want, **case):
    """Kernel 16's partials (acc, m, l) against the plain ones: each within
    2 bf16 ulps of its largest magnitude, or exactly (0, -1e30, 0) where no
    chunk column is live."""
    if not bool((want[2] > 0).any()):
        exact = all(bool((t[0] == 0).all() and (t[1] == -1e30).all() and (t[2] == 0).all())
                    for t in (got, want))
        results.append({"kernel": "v6_partials", **case, "part": "none live",
                        "max_abs_err": 0.0, "tol": 0.0})
        if not exact:
            raise AssertionError(f"v6 partials with no live column are not (0, -1e30, 0): "
                                 f"{case}")
        return
    for part, a, b in zip(("acc", "m", "l"), got, want):
        _check(results, worst, "v6_partials", a, b,
               KERNEL_TOL_ULPS * 2.0 ** -8 * b.abs().max().item(), part=part, **case)


def _archive_ladder(g, dev, flush, B, mc, nc, W, wl, G):
    """Device ms (L2 flushed) of kernels 10 and 11, the v1 chain, v2-v5,
    kernel 16 alone, the whole v6 and kernel 6 at one shape, Hkv=8,
    sparsity 0.7, each beside its plain version's ms and its bound from
    these inputs' bytes and operations."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    Hkv, D = 8, 128
    BH = B * Hkv
    fmt = sf.ChunkFormat(256, 128, 40)
    bf = torch.bfloat16
    pools = _archive_pools(torch.randn((2, BH, mc, 256, D), generator=g, device=dev).to(bf),
                           fmt)
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(bf)
    kw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
    vw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
    qpad = torch.zeros((BH, 8, D), dtype=bf, device=dev)
    qpad[:, :G] = q.reshape(BH, G, D)
    w = torch.zeros((BH, 8, mc * 256), dtype=bf, device=dev)
    w[:, :G, :nc * 256] = torch.rand((BH, G, nc * 256), generator=g, device=dev) / (nc * 256)
    (ks, kb), (vs, vb) = pools["head"]
    calls = {"key_scores": (lambda: sar.sparse_key_scores(qpad, ks, kb, nc, fmt, mc),
                            lambda: sar.sparse_key_scores_plain(qpad, ks, kb, nc, fmt, mc)),
             "value_combine": (lambda: sar.sparse_value_combine(w, vs, vb, nc, fmt, mc),
                               lambda: sar.sparse_value_combine_plain(w, vs, vb, nc, fmt,
                                                                      mc)),
             **_archive_calls(pools, q, kw, vw, nc, wl, fmt, mc)}
    sp = pools["stream"][0]
    calls["v6_kernel"] = (
        lambda: sar.fused_sparse_decode_attention_v6_partials(q, sp, nc, wl, fmt, fmt, mc),
        lambda: sar.fused_sparse_decode_attention_v6_partials_plain(q, sp, nc, wl, fmt, fmt))
    chunk_bytes = BH * nc * fmt.bytes_per_chunk                   # one stream
    spmv_flops = BH * 8 * nc * 256 * D * 2
    decode = (2 * chunk_bytes + BH * 2 * wl * D * 2 + 2 * q.numel() * 2,
              BH * G * (nc * 256 + wl) * D * 2 * 2)
    work = {"key_scores": (chunk_bytes + qpad.numel() * 2 + BH * 8 * mc * 256 * 4, spmv_flops),
            "value_combine": (chunk_bytes + BH * 8 * nc * 256 * 2 + BH * 8 * D * 4,
                              spmv_flops),
            "v1": decode, "v2": decode, "v3": decode, "v4": decode, "v5": decode,
            "v6": decode, "kernel6": decode,
            # the pools, q and the partials acc, m, l
            "v6_kernel": (2 * chunk_bytes + q.numel() * 2 + BH * G * (D + 2) * 4,
                          BH * G * nc * 256 * D * 2 * 2)}
    out = {}
    for name, (fn, plain) in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        ms, behind = cuda_ms(fn, 50, flush=flush)
        plain_ms, _ = cuda_ms(plain, 5, flush=flush, spin=False)
        nbytes, flops = work[name]
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        flops_ms = flops / H100_F32_FLOPS * 1e3
        out[name] = {"cuda_ms": ms, "host_behind": behind, "plain_ms": plain_ms,
                     "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
                     "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms)}
    return {"shape": {"B": B, "Hkv": Hkv, "G": G, "mc": mc, "n_chunks": nc, "W": W,
                      "win_len": wl, "sparsity": 0.7}, "timed": out}


def phase_kernel_archive():
    """Kernels 10-16 against their plain versions on random chunks pruned
    and packed on the card (B=8, Hkv=8, mc=5, W=288; sparsity 0.7 and 0.5;
    G 1/2/4/8; (n_chunks, win_len) of ``ARCHIVE_CASES``), the v1 chain
    against its plain chain, v6's partials, v6's sliding windows at 5
    chunks, v5 at hpb 8 and 2, nothing to attend (v1 and v6 NaN, v2-v4 the
    head's window mean, v5 its grid step's); kernels 12 and 13 also against
    their split plain versions (``split_gate``) in every case (at G = 4
    with an f32 q too), and each in
    one CUDA graph across ``ARCHIVE_GRAPH_COUNTS``; then the ladder at
    kernel 6's phase shape and at docs/PERFORMANCE.md's.  Returns the kernels-line
    entries (launches filled in by ``phase_kernel_archive_cache``)."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    counts0 = _launches()
    bf = torch.bfloat16
    B, Hkv, mc, W, D = 8, 8, 5, 288, 128
    BH = B * Hkv
    ulps = KERNEL_TOL_ULPS * 2.0 ** -8
    results = []
    worst = dict.fromkeys(("key_scores", "value_combine", "v1", "v2", "v3", "v4", "v5", "v6",
                           "v6_partials"), 0.0)
    worst_split = {"v2": 0.0, "v3": 0.0}
    f32_q_cases = {"v2": 0, "v3": 0}
    mean_bits = {}          # v2 / v3 at nothing to attend: bit-equal to the split plain
    graphs = {}
    for sparsity in (0.7, 0.5):
        fmt = sf.ChunkFormat(256, 128, 128 - int(sparsity * 128) + 1)
        pools = _archive_pools(
            torch.randn((2, BH, mc, 256, D), generator=g, device=dev).to(bf), fmt)
        (ks, kb), (vs, vb) = pools["head"]
        sp = pools["stream"][0]
        kw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
        vw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
        for G in (1, 2, 4, 8):
            q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(bf)
            qpad = torch.zeros((BH, 8, D), dtype=bf, device=dev)
            qpad[:, :G] = q.reshape(BH, G, D)
            for nc, wl in ARCHIVE_CASES:
                case = {"sparsity": sparsity, "G": G, "n_chunks": nc, "win_len": wl}
                got = sar.sparse_key_scores(qpad, ks, kb, nc, fmt, mc)
                torch.cuda.synchronize()
                want = sar.sparse_key_scores_plain(qpad, ks, kb, nc, fmt, mc)
                if not (got[:, :, nc * 256:] == 0).all():
                    raise AssertionError(f"kernel 10 wrote non-zero scores past "
                                         f"n_chunks: {case}")
                _check(results, worst, "key_scores", got, want,
                       SCORES_RTOL * want.abs().max().item(), **case)
                w = torch.zeros((BH, 8, mc * 256), dtype=bf, device=dev)
                w[:, :G, :nc * 256] = torch.softmax(
                    torch.randn((BH, G, nc * 256), generator=g, device=dev), -1).to(bf)
                got = sar.sparse_value_combine(w, vs, vb, nc, fmt, mc)
                torch.cuda.synchronize()
                want = sar.sparse_value_combine_plain(w, vs, vb, nc, fmt, mc)
                _check(results, worst, "value_combine", got, want,
                       ulps * want.abs().max().item(), **case)
                splits = _archive_split_plains(pools, q, kw, vw, nc, wl, fmt, mc)
                # at G = 4 kernels 12 and 13 also take an f32 q (an f32 output)
                calls32 = (_archive_calls(pools, q.float(), kw, vw, nc, wl, fmt, mc)
                           if G == 4 else {})
                for gen, (fn, plain) in _archive_calls(pools, q, kw, vw, nc, wl, fmt,
                                                       mc).items():
                    if gen == "kernel6":
                        continue
                    got = fn()
                    torch.cuda.synchronize()
                    want = plain()
                    # v4-v6: same arithmetic, sums in another order, a bf16(p) or
                    # the bf16 output may move by one ulp each; v2, v3: steps of
                    # 64 tokens and window tiles round p at their own maxima
                    _check(results, worst, gen, got, want,
                           ulps * want.float().abs().max().item(), **case)
                    if gen in splits:
                        want32 = splits[gen]()
                        outs = [got] + ([calls32[gen][0]()] if calls32 else [])
                        for out in outs:
                            r = split_gate(out, want32, slice(None))
                            worst_split[gen] = max(worst_split[gen], r)
                            if r > 1.0:
                                raise AssertionError(f"{gen} ({out.dtype} q) against its "
                                                     f"split plain version: {r} of the "
                                                     f"gate, {case}")
                        if calls32:
                            f32_q_cases[gen] += 1
                            if not torch.equal(outs[1].to(got.dtype), got):
                                raise AssertionError(f"{gen}: the f32 q's output rounded "
                                                     f"is not the bf16 q's, {case}")
                got = sar.fused_sparse_decode_attention_v5(q, sp, kw, vw, nc, wl, fmt, fmt,
                                                           mc, hpb=2)
                want = sar.fused_sparse_decode_attention_v5_plain(q, sp, kw, vw, nc, wl, fmt,
                                                                  fmt, mc, hpb=2)
                _check(results, worst, "v5", got, want,
                       ulps * want.float().abs().max().item(), hpb=2, **case)
                for window in (None,) + (ARCHIVE_WINDOWS if nc == mc else ()):
                    opt = {"window": window}
                    _check_partials(results, worst, sar.fused_sparse_decode_attention_v6_partials(
                        q, sp, nc, wl, fmt, fmt, mc, **opt),
                        sar.fused_sparse_decode_attention_v6_partials_plain(
                            q, sp, nc, wl, fmt, fmt, **opt), **case, **opt)
                    if window is not None:
                        got = sar.fused_sparse_decode_attention_v6(q, sp, kw, vw, nc, wl, fmt,
                                                                   fmt, mc, **opt)
                        want = sar.fused_sparse_decode_attention_v6_plain(
                            q, sp, kw, vw, nc, wl, fmt, fmt, mc, **opt)
                        _check(results, worst, "v6", got, want,
                               ulps * want.float().abs().max().item(), **case, **opt)
        # nothing to attend: v1 and v6 NaN, v2-v4 the mean of the head's
        # whole window, v5 the mean over the hpb heads of its grid step
        G = 4
        q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(bf)
        calls = _archive_calls(pools, q, kw, vw, 0, 0, fmt, mc)
        heads = vw.float().permute(0, 2, 1, 3).reshape(BH, W, D)
        splits = _archive_split_plains(pools, q, kw, vw, 0, 0, fmt, mc)
        calls32 = _archive_calls(pools, q.float(), kw, vw, 0, 0, fmt, mc)
        for gen in ("v2", "v3"):
            want32 = splits[gen]()
            got, got32 = calls[gen][0](), calls32[gen][0]()
            for out in (got, got32):
                r = split_gate(out, want32, slice(None))
                worst_split[gen] = max(worst_split[gen], r)
                if r > 1.0:
                    raise AssertionError(f"{gen} ({out.dtype} q) with nothing to attend "
                                         f"against its split plain version (the window "
                                         f"mean): {r} of the gate")
            mean_bits[f"{gen}_{sparsity}"] = bool(torch.equal(got, want32.to(got.dtype))
                                                  and torch.equal(got32, want32))
        if sparsity == 0.7:          # one CUDA graph of each across count changes
            (ks, kb), (vs, vb) = pools["head"]
            (cks, ckb), (cvs, cvb) = pools["chunk"]
            graphs["v2"] = _archive_graph_replays(
                lambda nc, wl: sar.fused_sparse_decode_attention(q, ks, kb, vs, vb, kw, vw, nc,
                                                                 wl, fmt, fmt, mc))
            graphs["v3"] = _archive_graph_replays(
                lambda nc, wl: sar.fused_sparse_decode_attention_v3(
                    q, cks, ckb, cvs, cvb, kw, vw, nc, wl, fmt, fmt, mc))
        for gen, hpb in (("v2", 1), ("v3", 1), ("v4", 1), ("v5", 8), ("v5", 2)):
            # the mean over groups of hpb heads (one head: v2-v4)
            mean = heads.reshape(BH // hpb, hpb * W, D).mean(dim=1).repeat_interleave(
                hpb, dim=0)[:, None].expand(BH, G, D).reshape(B, 1, Hkv * G, D)
            got = (calls[gen][0]() if gen != "v5" else sar.fused_sparse_decode_attention_v5(
                q, sp, kw, vw, 0, 0, fmt, fmt, mc, hpb=hpb)).float()
            want = (calls[gen][1]() if gen != "v5" else
                    sar.fused_sparse_decode_attention_v5_plain(q, sp, kw, vw, 0, 0, fmt, fmt,
                                                               mc, hpb=hpb)).float()
            tol = ulps * mean.abs().max().item()
            err = max((got - mean).abs().max().item(), (want - mean).abs().max().item())
            if err > tol:
                raise AssertionError(f"{gen} (hpb {hpb}) with nothing to attend is not the "
                                     f"mean of its heads' windows: {err} > {tol}")
        nan = [calls[gen][k]() for gen in ("v1", "v6") for k in (0, 1)]
        if not all(bool(x.isnan().all()) for x in nan):
            raise AssertionError("v1 or v6 with nothing to attend is not NaN")
    nothing = ("v1 and v6 NaN (kernels and plain); v2, v3 and v4 the mean of the head's 288 "
               "window rows (v2 and v3 also against their split plain versions' mean, "
               "summed in row order); v5 the mean of the windows of the 8 (hpb 8) or 2 "
               "(hpb 2) heads of its grid step")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    ladder = {"a": _archive_ladder(g, dev, flush_buf.zero_, 8, 5, 1, 288, 288, 4),
              "b": _archive_ladder(g, dev, flush_buf.zero_, 32, 3, 3, 288, 132, 4)}
    _set_launches(counts0)                                 # comparisons do not count
    by_kind = {k: [r for r in results if r["kernel"] == k] for k in worst}
    emit("kernel_archive", shapes={"B": B, "Hkv": Hkv, "mc": mc, "W": W},
         cases={"sparsity": (0.7, 0.5), "G": (1, 2, 4, 8), "n_chunks_win_len": ARCHIVE_CASES,
                "v6_windows_at_5_chunks": ARCHIVE_WINDOWS, "v5_hpb": (8, 2)},
         n_cases={k: len(v) for k, v in by_kind.items()},
         max_abs_err={k: max(r["max_abs_err"] for r in v) for k, v in by_kind.items()},
         worst_err_over_tol=worst, worst_err_over_tol_split=worst_split,
         tol_split=SPLIT_TOL_NOTE, window_mean_bit_equal_to_split_plain=mean_bits,
         f32_q_cases=f32_q_cases,
         graph_replays={gen: len(r) for gen, r in graphs.items()},
         nothing_to_attend=nothing, ladder=ladder,
         seconds=time.perf_counter() - t_phase)
    entries = {}
    for kind in ARCHIVE_KINDS:
        # v6's kernel is kernel 16 alone (the partials); the whole function
        # (kernel, torch window and merge) stands beside it
        t = ladder["a"]["timed"]["v6_kernel" if kind == "v6" else kind]
        tol = ("1e-5 of the largest score" if kind == "key_scores"
               else "2 bf16 ulps of the output's largest magnitude (v6: of the whole "
                    "function's output, and of each partial's)" if kind == "v6"
               else "2 bf16 ulps of the output's largest magnitude")
        e = _entry("archive", kind, by_kind[kind], worst[kind], tol, t["cuda_ms"], t["plain_ms"],
                   t["bytes_ms"], t["flops_ms"])
        e.update(timed_at="ladder (a): B=8, Hkv=8, G=4, mc=5, 1 chunk + 288 window",
                 ladder={s: ladder[s]["timed"][kind] for s in ladder})
        if kind in worst_split:
            e.update(worst_err_over_tol_split=worst_split[kind], tol_split=SPLIT_TOL_NOTE,
                     graph_replays=graphs[kind])
        if kind == "v6":
            e.update(partials_max_abs_err=max(r["max_abs_err"] for r in by_kind["v6_partials"]),
                     partials_worst_err_over_tol=worst["v6_partials"],
                     kernel_alone={s: ladder[s]["timed"]["v6_kernel"] for s in ladder})
        entries[("archive", kind)] = e
    return entries


def phase_kernel_archive_cache(k, v):
    """The archive's main path: v1-v6 and kernel 6 on every layer of the
    model's own cache (``serve_dense``'s K and V [L, B=8, S, Hkv, 128], 599
    rows written).  Rows 0-511 become two chunks, pruned at sparsity 0.7
    and packed as split pools and as fused streams (one stacked pool [L, 2,
    BH, rows, 128], read a layer view at a time); rows 512-598 are the
    window (W=288); q is seeded.  Per layer v2 agrees with v1 and v4 with
    v2 to 3e-2, v3 and kernel 6 with v2 and v5 and v6 with v4 to 2e-2 (the
    JAX chain's tolerances, tests/test_kernels_archive.py).  Returns the
    launches of the run, one of each kernel a layer."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    L, B, S, Hkv, D = k.shape
    if S != 800 or bool((k[:, :, 599:] != 0).any()) or bool((k[:, :, 598] == 0).all()):
        raise AssertionError("expected serve_dense's cache with 599 written rows")
    BH, G, W, nc, wl = B * Hkv, 4, 288, 2, 599 - 512
    fmt = sf.ChunkFormat(256, 128, 40)
    g = torch.Generator(device=k.device)
    g.manual_seed(11)
    before = _launches()
    _set_launches(dict.fromkeys(before, 0))
    pairs = (("v2_vs_v1", "v2", "v1", 3e-2), ("v3_vs_v2", "v3", "v2", 2e-2),
             ("kernel6_vs_v2", "kernel6", "v2", 2e-2), ("v4_vs_v2", "v4", "v2", 3e-2),
             ("v5_vs_v4", "v5", "v4", 2e-2), ("v6_vs_v4", "v6", "v4", 2e-2))
    worst = {name: 0.0 for name, *_ in pairs}
    tols = {name: tol for name, _, _, tol in pairs}
    stacked = torch.empty((L, nc, BH, 2 * fmt.stream_rows, D), dtype=torch.int16,
                          device=k.device)
    for li in range(L):
        x = torch.stack([k[li, :, :512], v[li, :, :512]])          # [2, B, 512, Hkv, D]
        x = x.reshape(2, B, 2, 256, Hkv, D).permute(0, 1, 4, 2, 3, 5).reshape(2, BH, 2, 256, D)
        pools = _archive_pools(x.contiguous(), fmt)
        stacked[li] = pools["stream"][0]
        pools["stream"] = stacked[li:li + 1]           # v4-v6 read stacked[li], a view
        q = torch.randn((B, 1, Hkv * G, D), generator=g, device=k.device).to(torch.bfloat16)
        calls = _archive_calls(pools, q, k[li, :, 512:].contiguous(),
                               v[li, :, 512:].contiguous(), nc, wl, fmt, nc)
        outs = {gen: fn().float() for gen, (fn, _) in calls.items()}
        for name, a, b, tol in pairs:
            # allclose(a, b, rtol=tol, atol=tol): the worst of |a - b| / (tol + tol |b|)
            ratio = ((outs[a] - outs[b]).abs() / (tol * (1 + outs[b].abs()))).max()
            if not (outs[a].isfinite().all() and ratio.item() <= 1.0):
                raise AssertionError(f"layer {li}: {name} off by {ratio.item():.3g} of "
                                     f"its tolerance {tol}")
            worst[name] = max(worst[name], ratio.item())
    torch.cuda.synchronize()
    launches = {n: c for n, c in _launches().items() if c}
    want = {f"archive.{n}": L for n in (
        "sparse_key_scores", "sparse_value_combine", "fused_sparse_decode_attention",
        "fused_sparse_decode_attention_v3", "fused_sparse_decode_attention_v4",
        "fused_sparse_decode_attention_v5", "fused_sparse_decode_attention_v6")}
    want["fused_sparse_decode_attention"] = L
    _set_launches(before)
    emit("kernel_archive_cache", layers=L, B=B, Hkv=Hkv, G=G, n_chunks=nc, win_len=wl, W=W,
         sparsity=0.7, worst_over_tol=worst, tolerances=tols, kernel_launches=launches)
    if launches != want:
        raise AssertionError(f"kernel_archive_cache launched {launches}, expected {want}")
    return launches


def _tiny_engine(mode, codec="q8q4", method=None, window=None, moe=False, **kw):
    """The tiny model's engine; ``moe``: its MLP Mixtral's (4 experts, top-2,
    capacity factor 1: a prefill drops tokens)."""
    import dataclasses
    from mustafar_tpu_torch import config as tc
    model = dataclasses.replace(tc.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256, sliding_window=window)
    if moe:
        model = dataclasses.replace(model, num_experts=4, num_experts_per_tok=2,
                                    expert_capacity_factor=1.0)
    return tc.EngineConfig(
        model=model, cache_mode=mode,
        prune=tc.PruneConfig(method=method or tc.PruneMethod.KT_MAG_VT_MAG,
                             k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=kw.pop("max_seq_len", 1024), prefill_bucket=256, chunk_size=256,
        codec=codec, **kw)


def _counters():
    """The launch count of every kernel wrapper, by name: the serving ones
    (``runtime.graphs.kernel_wrappers``) and the archive's."""
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    from mustafar_tpu_torch.runtime.graphs import kernel_wrappers
    counters = kernel_wrappers()
    # the archive's v2 has the production kernel's name: its keys are prefixed
    counters.update({f"archive.{fn.__name__}": fn for fn in (
        sar.sparse_key_scores, sar.sparse_value_combine,
        sar.fused_sparse_decode_attention, sar.fused_sparse_decode_attention_v3,
        sar.fused_sparse_decode_attention_v4, sar.fused_sparse_decode_attention_v5,
        sar.fused_sparse_decode_attention_v6)})
    return counters


def _launches():
    """Each wrapper's launches: those it counted itself, plus those the
    CUDA graphs of the decode step launched by replays (captured launches x
    replays, ``runtime.graphs.REPLAYED``)."""
    from mustafar_tpu_torch.runtime.graphs import REPLAYED
    return {name: fn.launches + REPLAYED[name] for name, fn in _counters().items()}


def _set_launches(counts):
    """Every wrapper's count set to ``counts`` (a ``_launches`` reading),
    the replayed launches folded in."""
    from mustafar_tpu_torch.runtime.graphs import REPLAYED
    REPLAYED.clear()
    for name, fn in _counters().items():
        fn.launches = counts[name]


def _recording_engine():
    """The continuous-batching engine with its token choice recorded per
    request (``logits``), optionally fed given streams (teacher forcing)."""
    import numpy as np
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine

    class Recording(ContinuousBatchingEngine):
        def __init__(self, *args, streams=None, **kw):
            super().__init__(*args, **kw)
            self.streams = streams
            self.logits = {}

        def _choose(self, logits2d, reqs):
            picks = super()._choose(logits2d, reqs)
            for i, req in enumerate(reqs):
                if req is not None:
                    self.logits.setdefault(req.uid, []).append(logits2d[i].float().cpu())
                    if self.streams is not None:
                        picks[i] = self.streams[req.uid][len(req.out)]
            return picks

    return Recording, np


def _to_card(params):
    """A params dict's leaves copied to the card (their strides kept)."""
    return {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict)
                else v.cuda()) for k, v in params.items()}


def _ulp_up(params):
    """``params`` with every int8 weight's scales one ulp up: a last-bit
    change of every projection's output, as another device's sums make."""
    import torch

    def up(leaves):
        return {k: torch.nextafter(v, torch.full_like(v, float("inf")))
                if k.endswith("_scale") else v for k, v in leaves.items()}

    return dict(up({k: v for k, v in params.items() if k != "layers"}),
                layers=up(params["layers"]))


# W8A8 turns last-bit differences of the activations into a step of an int8
# code wherever a value sits at a rounding edge, so card and CPU part by about
# as much as the CPU parts from itself when every weight scale moves one ulp
# (the CPU tests hold the port to JAX by the same rule): a W8A8 run is held
# to 1e-2 of the logits' range or 3x that spread, whichever is larger
A8_SPREAD_NOTE = ("W8A8: within max(1e-2 of the logits' range, 3x the CPU's own spread "
                  "when every weight scale moves one ulp)")
A8_PICKS_NOTE = ("every greedy pick equal, or at a near-tie: the CPU's margin between its "
                 "token and the card's within SWA_TIE_TOL or, under W8A8, within twice "
                 "the run's largest logit difference (itself within A8_SPREAD_NOTE's bound)")


def _wide_flips(fields, a8=False):
    """The run's differing picks that A8_PICKS_NOTE does not allow."""
    tie = max(SWA_TIE_TOL, 2 * fields["max_abs_err"]) if a8 else SWA_TIE_TOL
    return [f for f in fields["flips"] if f["cpu_margin"] > tie]


def phase_reference(codec="q8q4", mode=None, method=None, use_pallas=False, T=300,
                    tol_frac=1e-2, window=None, chunked=False, moe=False, quant=None):
    """A tiny f32 model, same weights and token stream on the card and on
    the CPU: the card runs the kernel, the CPU the plain path, a prompt of
    ``T`` tokens and 39 decode steps (a compressed cache compacts when its
    window fills, as the Generator does).  ``mode`` and ``method`` default
    to the compressed cache and KT_MAG_VT_MAG; ``use_pallas`` sends a dense
    or masked cache through kernel 4; ``tol_frac`` is the logits'
    tolerance as a fraction of their range; ``window`` gives the model a
    sliding window; ``chunked`` prefills the prompt segment by segment
    (chunked prefill, the segment kernel); ``moe`` gives it Mixtral's MLP;
    ``quant`` maps the CPU's params to a weight format before they are
    copied to the card (with the W8A8 markers the tolerance widens to
    A8_SPREAD_NOTE's, from a third, CPU run).  Returns the phase's
    numbers (``reference_bitmap`` and the others print them)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    eng = _tiny_engine(mode or CacheMode.COMPRESSED, codec, method, window, moe)
    cpu_params = llama.init_params(eng.model, device="cpu", dtype=torch.float32, seed=1)
    if quant is not None:
        cpu_params = quant(cpu_params)
    gpu_params = _to_card(cpu_params)
    a8 = "act_quant" in cpu_params
    prompt = np.random.RandomState(1).randint(0, 512, (2, T))
    toks = torch.zeros((2, -(-T // 256) * 256), dtype=torch.int64)
    toks[:, :T] = torch.from_numpy(prompt)
    launches0 = _launches()
    logs = {}
    stream = None
    compactions = 0
    runs = [("cpu", "cpu", cpu_params), ("cuda", "cuda", gpu_params)]
    if a8:
        runs.append(("cpu_ulp", "cpu", _ulp_up(cpu_params)))
    with torch.inference_mode():
        for run, dev, params in runs:
            impl = make_cache(eng, device=dev)
            impl.use_pallas = use_pallas
            cache = impl.init(2, torch.float32)
            if chunked:
                logit, cache = llama.prefill_chunked(eng.model, params, toks.to(dev), cache,
                                                     impl, T)
            else:
                logit, cache = llama.prefill(eng.model, params, toks.to(dev), cache,
                                             impl, T, last_only=True)
            out = [logit[:, 0].cpu()]
            tok = logit[:, 0].argmax(-1)
            for i in range(1, 40):
                if stream is not None:
                    tok = stream[:, i - 1].to(dev)
                logit, cache = llama.decode_step(eng.model, params, tok[:, None],
                                                 cache, impl, T + i - 1)
                out.append(logit[:, 0].cpu())
                tok = logit[:, 0].argmax(-1)
                if hasattr(impl, "compact") and impl.window_full(cache, T + i):
                    impl.compact(cache)
                    compactions += dev == "cuda"
            logs[run] = torch.stack(out, 1)
            if stream is None:
                stream = logs[run].argmax(-1)          # the CPU's greedy picks
    launched = {k: v - launches0[k] for k, v in _launches().items() if v > launches0[k]}
    _set_launches(launches0)
    a, b = logs["cpu"], logs["cuda"]
    err = (a - b).abs().max().item()
    scale = a.abs().max().item()
    # the kernel reads q and the window as bf16 and rounds p to bf16: last-bit
    # differences of f32 activations on the two devices can flip one of those
    # roundings (the CPU parity tests measure < 3e-3 of the logits' range)
    tol = tol_frac * scale
    spread = (logs["cpu_ulp"] - a).abs().max().item() if a8 else None
    if a8:
        tol = max(tol, 3 * spread)
    want, pick = a.argmax(-1), b.argmax(-1)
    agree = (want == pick).float().mean().item()
    # each differing pick with the CPU's margin between its token and the card's
    flips = [{"row": r, "step": t,
              "cpu_margin": (a[r, t, want[r, t]] - a[r, t, pick[r, t]]).item()}
             for r, t in torch.nonzero(pick != want).tolist()]
    fields = {"steps": 40, "max_abs_err": err, "tol": tol, "greedy_agreement": agree,
              "flips": flips, "launched": launched, "compactions": compactions}
    if a8:
        fields.update(logits_range=scale, cpu_ulp_spread=spread, tol_rule=A8_SPREAD_NOTE)
    if codec == "q8q4" and mode is None and method is None and not moe and quant is None:
        emit("reference", **fields)
    if not (b.isfinite().all() and err <= tol):
        raise AssertionError(f"card and CPU logits disagree on the tiny model: {fields}")
    return fields


def phase_reference_cb(codec="q8q4", method=None, window=None, moe=False):
    """The tiny f32 continuous-batching engine, chunked prefill with
    interleaved admission, on the CPU (plain versions) and on the card
    (kernels), fed the CPU's tokens: the card's logits within 1e-2 of their
    range, its own greedy picks equal to the CPU's.  The requests make a
    slot retire while the other decodes (its n_chunks still the old
    request's) and reuse it.  ``method`` defaults to KT_MAG_VT_MAG;
    ``window`` gives the model a sliding window, and then (as under Opa) a
    pick may differ at a near-tie, within SWA_TIE_TOL.  Returns the phase's
    numbers.  ``moe`` gives the model Mixtral's MLP."""
    import torch
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    Recording, np = _recording_engine()
    eng = _tiny_engine(CacheMode.COMPRESSED, codec, method, window, moe, max_seq_len=2048,
                       batch_size=2, chunked_prefill=True)
    cpu_params = llama.init_params(eng.model, device="cpu", dtype=torch.float32, seed=2)
    gpu_params = _to_card(cpu_params)
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(0, 512, size=n), m)
            for n, m in ((100, 12), (1000, 6), (280, 30), (530, 20))]
    counts0 = _launches()
    runs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        streams = None if dev == "cpu" else runs["cpu"][0]
        cb = Recording(eng, params, dtype=torch.float32, device=dev, streams=streams)
        for p, m in reqs:
            cb.submit(p, m)
        runs[dev] = (cb.run(), cb.logits, cb.ticks, cb.segments, cb.decode_steps)
    launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
    _set_launches(counts0)
    toks, lc, ticks, segments, steps = runs["cpu"]
    _, lg, *_ = runs["cuda"]
    err, scale, agree, n, flips = 0.0, 0.0, 0, 0, []
    for uid in toks:
        a, b = torch.stack(lc[uid]), torch.stack(lg[uid])
        err = max(err, (a - b).abs().max().item())
        scale = max(scale, a.abs().max().item())
        want, pick = torch.as_tensor(toks[uid]), b.argmax(-1)
        agree += int((pick == want).sum())
        n += len(toks[uid])
        flips += [{"uid": uid, "step": t, "cpu_margin": (a[t, want[t]] - a[t, pick[t]]).item()}
                  for t in torch.nonzero(pick != want).flatten().tolist()]
    tol = 1e-2 * scale
    fields = {"requests": len(reqs), "tokens": n, "ticks": ticks, "segments": segments,
              "decode_steps": steps, "max_abs_err": err, "tol": tol,
              "greedy_agreement": agree / n, "flips": flips, "launched": launched}
    if codec == "q8q4" and method is None and window is None and not moe:
        emit("reference_cb", **fields)
    # under Opa (OPA_CB_NOTE) a differing pick must be a near-tie on the CPU,
    # with the window or the MoE MLP one within SWA_TIE_TOL (SWA_PICKS_NOTE)
    picks_ok = agree == n if method is None and window is None and not moe else all(
        f["cpu_margin"] <= (SWA_TIE_TOL if window or moe else 2 * err) for f in flips)
    if not (err <= tol and picks_ok):
        raise AssertionError(f"card and CPU disagree on the tiny continuous-batching "
                             f"run: {fields}")
    return fields


def phase_reference_bitmap(codec="bitmap"):
    """``reference`` and ``reference_cb`` with a bitmap codec (bitmap, or
    bitmap-q8 as ``reference_bitmap_q8``): the Generator's decode path and
    the engine (per-slot decode, segments) through the bitmap kernels on
    the card, against the plain versions on the CPU.  Each run must have
    launched exactly the bitmap kernels."""
    gen, cb = phase_reference(codec), phase_reference_cb(codec)
    label = "reference_" + codec.replace("-", "_")
    emit(label, generator=gen, engine=cb)
    if set(gen["launched"]) != {"fused_sparse_decode_attention"} or set(
            cb["launched"]) != {"fused_sparse_decode_attention_ps",
                                "fused_sparse_segment_attention"}:
        raise AssertionError(f"{label}: launched {gen['launched']} and {cb['launched']}")


def phase_reference_q():
    """``reference`` and ``reference_cb`` with the codecs q8 and q4q4: the
    Generator's decode path (kernel 1, and kernel 9 at prefill) and the
    engine (kernels 2, 3 and 9) on the card against the plain versions on
    the CPU, logits within 1e-2 of their range.  Each run must have
    launched exactly its codec's kernels.  Returns the engine runs'
    launches by codec."""
    runs = {codec: (phase_reference(codec), phase_reference_cb(codec))
            for codec in ("q8", "q4q4")}
    emit("reference_q", **{c: {"generator": gen, "engine": cb}
                           for c, (gen, cb) in runs.items()})
    for codec, (gen, cb) in runs.items():
        if set(gen["launched"]) != {"fused_q_decode_attention", "prune_quant_pack_kv"} or set(
                cb["launched"]) != {"fused_q_decode_attention_ps",
                                    "fused_q_segment_attention", "prune_quant_pack_kv"}:
            raise AssertionError(f"reference_q ({codec}): launched {gen['launched']} and "
                                 f"{cb['launched']}")
    return {codec: cb["launched"] for codec, (_, cb) in runs.items()}


SWA_TINY_WINDOW, SWA_TINY_T = 320, 600
SWA_TIE_TOL = 1e-2   # absolute: the CPU tests' TIE_TOL for a kernel's route
SWA_PICKS_NOTE = ("every greedy pick equal, or at a near-tie: the CPU's margin between its "
                  "token and the card's pick at most SWA_TIE_TOL = 1e-2, the tie "
                  "tolerance the CPU tests hold a kernel's route to against the JAX "
                  "package (tests/test_torch_generate.py, tests/test_torch_w4.py), a "
                  "fixed bound that no run's error sets. The kernels round q, the "
                  "window and p to bf16 and the f32 activations differ in their last "
                  "bits between card and CPU, so a pick whose top-2 logits lie that "
                  "close may flip (on an H100: one of 80 at q4q4 at a CPU margin of "
                  "3.6e-5, one of 80 through kernel 4 at 1.4e-3)")


def phase_reference_swa():
    """``reference`` on a tiny f32 model with a sliding window of 320, card
    against CPU: a 600-token prompt (banded prefill; 2 chunks packed, 88
    window tokens) and 39 decode steps from position 600 (first live pool
    column 281: chunk 0 wholly below the window, chunk 1 cut), as the
    Generator runs them, at every codec (kernels 1 and 6 with ``window``,
    kernel 9 at prefill), the dense cache through kernel 4 with ``window``,
    and the masked cache (plain route, KT_MAG_VT_MAG at 0.7); logits within
    1e-2 of their range and every greedy pick equal or at a near-tie
    within SWA_TIE_TOL (SWA_PICKS_NOTE); each run launched its kernels and
    no other."""
    from mustafar_tpu_torch.config import CacheMode
    steps = 2 * 39
    runs = {}
    cases = [(CacheMode.COMPRESSED, c, False,
              {"fused_q_decode_attention": steps, "prune_quant_pack_kv": 2}
              if c in QUANT_BITS else {"fused_sparse_decode_attention": steps})
             for c in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8")]
    cases += [(CacheMode.DENSE, "q8q4", True, {"flash_decode_attention": steps}),
              (CacheMode.MASKED, "q8q4", False, {})]
    for mode, codec, use_pallas, want in cases:
        label = f"{mode.value}/{codec}" if mode == CacheMode.COMPRESSED else (
            f"{mode.value}" + ("/kernel4" if use_pallas else ""))
        fields = phase_reference(codec, mode, None, use_pallas, T=SWA_TINY_T,
                                 window=SWA_TINY_WINDOW)
        runs[label] = dict(fields, expected_launches=want)
        runs[label]["picks"] = SWA_PICKS_NOTE
        if fields["launched"] != want:
            raise AssertionError(f"reference_swa ({label}): launched {fields['launched']}, "
                                 f"expected {want}")
        wide = [f for f in fields["flips"] if f["cpu_margin"] > SWA_TIE_TOL]
        if wide:
            raise AssertionError(f"reference_swa ({label}): greedy picks flipped at a CPU "
                                 f"margin past SWA_TIE_TOL ({SWA_TIE_TOL}): {wide}")
    emit("reference_swa", window=SWA_TINY_WINDOW, prompt=SWA_TINY_T, runs=runs)
    return runs


def phase_reference_swa_cb():
    """The sliding window through the engine and chunked prefill over the
    compressed cache, tiny f32 model (window 320), card against CPU: the
    engine (``reference_cb``'s requests: segments whose rows see part of a
    chunk or none of the pool, per-slot decode with chunks below a slot's
    edge, compactions) at every codec (kernels 2 and 7, 3 and 8 with the
    window; kernel 9 at the quant codecs), and the chunked Generator
    (``reference`` with chunked prefill, 600 tokens: 3 segments, then 39
    decode steps through kernels 1 and 6) at q8q4 and bitmap; logits within
    1e-2 of their range, picks equal or at a near-tie within SWA_TIE_TOL
    (SWA_PICKS_NOTE); the per-slot and segment kernels launched once a layer
    a step and a segment, and no kernel of another codec.  Returns the
    runs."""
    from mustafar_tpu_torch.config import CacheMode, TINY_LLAMA
    from mustafar_tpu_torch.models.llama import n_segments
    L = TINY_LLAMA.num_layers
    runs = {}
    for codec in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8"):
        fields = phase_reference_cb(codec, window=SWA_TINY_WINDOW)
        want = {_meta(codec, "decode_ps")[0]: L * fields["decode_steps"],
                _meta(codec, "segment")[0]: L * fields["segments"]}
        got = {k: v for k, v in fields["launched"].items() if k in want}
        names = set(want) | ({"prune_quant_pack_kv"} if codec in QUANT_BITS else set())
        runs[f"engine/{codec}"] = dict(fields, expected_launches=want, picks=SWA_PICKS_NOTE)
        if got != want or set(fields["launched"]) != names:
            raise AssertionError(f"reference_swa_cb (engine, {codec}): launched "
                                 f"{fields['launched']}, expected {want} (and kernel 9 at "
                                 f"the quant codecs)")
    for codec in ("q8q4", "bitmap"):
        fields = phase_reference(codec, CacheMode.COMPRESSED, None, False, T=SWA_TINY_T,
                                 window=SWA_TINY_WINDOW, chunked=True)
        want = {_meta(codec, "decode")[0]: L * 39,
                _meta(codec, "segment")[0]: L * n_segments(SWA_TINY_T, 256)}
        if codec in QUANT_BITS:          # every segment stages its layer's pack
            want["prune_quant_pack_kv"] = L * n_segments(SWA_TINY_T, 256)
        runs[f"chunked_generator/{codec}"] = dict(fields, expected_launches=want,
                                                  picks=SWA_PICKS_NOTE)
        wide = [f for f in fields["flips"] if f["cpu_margin"] > SWA_TIE_TOL]
        if fields["launched"] != want or wide:
            raise AssertionError(f"reference_swa_cb (chunked Generator, {codec}): launched "
                                 f"{fields['launched']} (expected {want}); flips past "
                                 f"SWA_TIE_TOL: {wide}")
    emit("reference_swa_cb", window=SWA_TINY_WINDOW, runs=runs)
    return runs


SAMPLE = {"temperature": 0.9, "top_k": 50, "top_p": 0.95, "seed": 7}


def phase_reference_sample():
    """Sampled decoding on the card (tiny f32 model, q8q4 compressed cache):
    the Generator (B=2, 300 + 40) and the engine (reference_cb's requests)
    with temperature 0.9, top-k 50, top-p 0.95, seed 7.  Every drawn token
    lies in the kept set of the CPU's filter (``filter_logits``) on the
    card's logits of that pick; the same seed draws the same tokens again;
    with top-k 1 the tokens are the greedy ones; at top-p 0 and -0.5 every
    draw is token 0 (the Generator's, and one on each recorded row)."""
    import dataclasses
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.runtime import generate as tg
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    hot = tg.SamplingParams(**SAMPLE)
    one = dataclasses.replace(hot, top_k=1)
    eng = _tiny_engine(CacheMode.COMPRESSED, "q8q4", max_seq_len=2048, batch_size=2,
                       chunked_prefill=True)
    params = llama.init_params(eng.model, device="cuda", dtype=torch.float32, seed=3)
    picks = []                       # (logits on the CPU, tokens, rows of a request)

    def filtered_out(rows_logits, toks, sp):
        kept = torch.isfinite(tg.filter_logits(rows_logits, sp))
        return int((~kept[torch.arange(len(toks)), toks]).sum())

    choose = tg.choose

    def recorded(logits2d, sp, step):
        tok = choose(logits2d, sp, step)
        picks.append((logits2d.float().cpu(), tok.cpu(), sp))
        return tok

    class Recording(ContinuousBatchingEngine):
        def _choose(self, logits2d, reqs):
            toks = super()._choose(logits2d, reqs)
            rows = [i for i, r in enumerate(reqs) if r is not None]
            picks.append((logits2d[rows].float().cpu(), torch.as_tensor(toks[rows]),
                          self.sampling))
            return toks

    prompt = np.random.RandomState(3).randint(0, 512, (2, 300))
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(0, 512, size=n), m)
            for n, m in ((100, 12), (1000, 6), (280, 30), (530, 20))]
    counts0 = _launches()
    tg.choose = recorded
    try:
        gen = tg.Generator(eng, params, dtype=torch.float32)
        runs = {name: np.stack(gen.generate(prompt, 40, sampling=sp))
                for name, sp in (("hot", hot), ("hot_again", hot), ("top_k_1", one))}
        runs["greedy"] = np.stack(gen.generate(prompt, 40))
    finally:
        tg.choose = choose
    gen_picks = len(picks)

    def engine(sp):
        cb = Recording(eng, params, dtype=torch.float32, sampling=sp)
        uids = [cb.submit(p, m) for p, m in reqs]
        out = cb.run()
        return [np.asarray(out[u]) for u in uids]
    cb_runs = {name: engine(sp) for name, sp in (("hot", hot), ("hot_again", hot),
                                                   ("top_k_1", one), ("greedy", tg.GREEDY))}
    engine_picks = len(picks) - gen_picks
    # at top_p <= 0 the filter keeps no token and the draw is token 0 (the
    # JAX package's categorical over all -inf): the Generator's, and one
    # draw on each recorded row of card logits
    zero_p = {}
    rows = torch.cat([lg for lg, _, _ in picks]).cuda()
    for p in (0.0, -0.5):
        sp = tg.SamplingParams(temperature=0.9, top_p=p, seed=7)
        toks = np.stack(gen.generate(prompt, 8, sampling=sp))
        drawn = tg.sample(rows, sp, 3)
        zero_p[str(p)] = {"generator_all_0": bool((toks == 0).all()),
                          "rows_all_0": bool((drawn == 0).all()), "rows": len(rows)}
    _set_launches(counts0)
    outside = sum(filtered_out(lg, tk, sp) for lg, tk, sp in picks if not sp.greedy)
    fields = {"sampling": SAMPLE, "generator_picks": gen_picks, "engine_picks": engine_picks,
              "drawn_outside_kept_set": outside,
              "generator": {"same_seed_equal": bool((runs["hot"] == runs["hot_again"]).all()),
                            "top_k_1_equal_greedy": bool((runs["top_k_1"]
                                                          == runs["greedy"]).all()),
                            "agreement_with_greedy": float((runs["hot"]
                                                            == runs["greedy"]).mean())},
              "engine": {"same_seed_equal": all((a == b).all() for a, b in
                                                zip(cb_runs["hot"], cb_runs["hot_again"])),
                         "top_k_1_equal_greedy": all((a == b).all() for a, b in
                                                     zip(cb_runs["top_k_1"],
                                                         cb_runs["greedy"]))},
              "top_p_at_or_below_0": zero_p}
    emit("reference_sample", **fields)
    if outside or not all(v for part in ("generator", "engine")
                          for k, v in fields[part].items() if k != "agreement_with_greedy") \
            or not all(z["generator_all_0"] and z["rows_all_0"] for z in zero_p.values()):
        raise AssertionError(f"reference_sample: {fields}")


CHANNEL_OPA_TOL = 5e-2   # of the logits' range (see phase_reference_masked)


def phase_reference_masked():
    """``reference`` on the masked cache (the EngineConfig default) for all
    eight pruning methods, card against CPU, logits within 1e-2 of their
    range: the plain route, and for the Opa methods the kernel route
    (``use_pallas``: kernel 4, with its final (m, l) where V is scored,
    2 layers x 39 steps).  KT_MAG_VC_OPA is held to CHANNEL_OPA_TOL and to
    every greedy pick equal: it ranks each group's 32 tokens per channel
    by w_t |v_td| (softmax weights summed in another order on the card),
    so near-ties flip which entries survive, on the plain route as on the
    kernel's, and each flip moves the logits."""
    from mustafar_tpu_torch.config import CacheMode, PruneMethod
    runs = {}
    for method in PruneMethod:
        kernel = "opa" in method.k_policy or "opa" in method.v_policy
        channel_opa = method.v_policy == "channel_opa"
        fields = phase_reference("q8q4", CacheMode.MASKED, method, use_pallas=kernel,
                                 tol_frac=CHANNEL_OPA_TOL if channel_opa else 1e-2)
        want = {"flash_decode_attention": 2 * 39} if kernel else {}
        runs[method.value] = dict(fields, use_pallas=kernel, expected_launches=want)
        if fields["launched"] != want or (channel_opa and fields["greedy_agreement"] < 1):
            raise AssertionError(f"reference_masked ({method.value}): launched "
                                 f"{fields['launched']}, expected {want}; {fields}")
    emit("reference_masked", runs=runs)


def phase_reference_opa():
    """``reference`` on the compressed cache under the Opa methods
    (KT_OPA_VT_MAG, KT_MAG_VT_OPA) at every codec, card against CPU: a
    543-token prompt (one chunk packed by its prefill scores, kernel 9 with
    a score on the card for the quant codecs), a compaction after the first
    step (the oldest C tokens packed by their accumulated scores), the
    uniform decode kernel with its window probabilities where V is scored;
    logits within 1e-2 of their range."""
    from mustafar_tpu_torch.config import CacheMode, PruneMethod
    runs = {}
    for method in (PruneMethod.KT_OPA_VT_MAG, PruneMethod.KT_MAG_VT_OPA):
        for codec in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8"):
            fields = phase_reference(codec, CacheMode.COMPRESSED, method, T=543)
            if codec in QUANT_BITS:
                want = {"fused_q_decode_attention": 2 * 39, "prune_quant_pack_kv": 2 + 1}
            else:
                want = {"fused_sparse_decode_attention": 2 * 39}
            runs[f"{method.value}/{codec}"] = dict(fields, expected_launches=want)
            if fields["launched"] != want or fields["compactions"] != 1:
                raise AssertionError(f"reference_opa ({method.value}, {codec}): launched "
                                     f"{fields['launched']}, expected {want}, "
                                     f"{fields['compactions']} compactions")
    emit("reference_opa", runs=runs)


OPA_CB_NOTE = ("every greedy pick equal, or at a near-tie: the CPU's margin between its "
               "token and the card's pick at most twice the largest logit difference. "
               "The Opa packs keep each row's top entries by accumulated scores whose "
               "float sums differ between card and CPU by ~1e-7, so a near-tie of the "
               "scores can flip a kept entry and move the logits by ~1e-3 of their range, "
               "and with it a pick whose top-2 logits lie closer")


def phase_reference_opa_cb():
    """``reference_cb`` under the Opa methods (KT_OPA_VT_MAG, KT_MAG_VT_OPA)
    at q8q4 and bitmap: the engine's per-slot decode scoring each slot's
    window (kernel 2 or 7 with its window probabilities where V is scored),
    compactions by score (``compact_slots``; kernel 9 with a score for
    q8q4) and chunked prefill's streamed scores (the segment kernel's
    partials), card against CPU: logits within 1e-2 of their range, every
    greedy pick equal or at a near-tie (OPA_CB_NOTE); each run launched its
    codec's kernels and no other.  Returns the runs' launches by (method,
    codec)."""
    from mustafar_tpu_torch.config import PruneMethod
    runs = {}
    for method in (PruneMethod.KT_OPA_VT_MAG, PruneMethod.KT_MAG_VT_OPA):
        for codec in ("q8q4", "bitmap"):
            fields = phase_reference_cb(codec, method)
            want = ({"fused_q_decode_attention_ps", "fused_q_segment_attention",
                     "prune_quant_pack_kv"} if codec in QUANT_BITS
                    else {"fused_sparse_decode_attention_ps", "fused_sparse_segment_attention"})
            runs[f"{method.value}/{codec}"] = dict(fields, expected_kernels=sorted(want),
                                                   picks=OPA_CB_NOTE)
            if set(fields["launched"]) != want:
                raise AssertionError(f"reference_opa_cb ({method.value}, {codec}): launched "
                                     f"{fields['launched']}, expected {sorted(want)}")
    emit("reference_opa_cb", runs=runs)
    return {key: run["launched"] for key, run in runs.items()}


REFERENCE_W4_TOL = 3e-2   # of the logits' range (see phase_reference_w4)


def phase_reference_w4():
    """A tiny model with W4 weights (f32 activations; the same params on the
    card and on the CPU), fed the CPU's greedy tokens on the card: the card
    runs kernel 5 for every projection of at most 128 tokens and the dense
    cache's kernel 4 (``use_pallas``) or the q8q4 kernel; the CPU runs the
    dequant route and the plain versions.  Runs: the dense cache at a
    batch-1 prompt of 100 tokens in a 128-token bucket (kernel 5 at
    prefill too) and at B=2, prompt 300 (a 384-token prefill: the dequant
    route); q8q4 at B=2, prompt 300; the dense engine (per-slot ticks
    through kernel 4), fed the CPU's tokens.  The kernel route reads each
    projection's input as bf16, the CPU's dequant route keeps it in f32:
    simulated on the CPU (the kernel's plain version for <= 128 tokens)
    that moves these logits by 7.7e-3 of their range, so they are held to
    3e-2 of it."""
    import dataclasses
    import numpy as np
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.models.quant import quantize_params_w4
    base = _tiny_engine(CacheMode.DENSE)
    cpu_params = quantize_params_w4(llama.init_params(base.model, device="cpu",
                                                      dtype=torch.float32, seed=3))
    gpu_params = _to_card(cpu_params)
    runs = {"dense_b1_prompt100": (CacheMode.DENSE, 1, 100, 128),
            "dense_b2_prompt300": (CacheMode.DENSE, 2, 300, 128),
            "q8q4_b2_prompt300": (CacheMode.COMPRESSED, 2, 300, 256)}
    results, ok = {}, True
    for label, (mode, B, T, bucket) in runs.items():
        eng = dataclasses.replace(_tiny_engine(mode), prefill_bucket=bucket)
        prompt = np.random.RandomState(B + T).randint(0, 512, (B, T))
        Tpad = -(-T // bucket) * bucket
        toks = torch.zeros((B, Tpad), dtype=torch.int64)
        toks[:, :T] = torch.from_numpy(prompt)
        logs, stream = {}, None
        counts0 = _launches()
        with torch.inference_mode():
            for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
                impl = make_cache(eng, device=dev)
                impl.use_pallas = True
                cache = impl.init(B, torch.float32)
                logit, cache = llama.prefill(eng.model, params, toks.to(dev), cache, impl,
                                             T, last_only=True)
                prefill_w4 = _launches()["w4_matmul"] - counts0["w4_matmul"]
                out = [logit[:, 0].cpu()]
                tok = logit[:, 0].argmax(-1)
                for i in range(1, 30):
                    if stream is not None:
                        tok = stream[:, i - 1].to(dev)
                    logit, cache = llama.decode_step(eng.model, params, tok[:, None],
                                                     cache, impl, T + i - 1)
                    out.append(logit[:, 0].cpu())
                    tok = logit[:, 0].argmax(-1)
                logs[dev] = torch.stack(out, 1)
                if stream is None:
                    stream = logs[dev].argmax(-1)          # the CPU's greedy picks
        launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
        _set_launches(counts0)
        a, b = logs["cpu"], logs["cuda"]
        err, scale = (a - b).abs().max().item(), a.abs().max().item()
        L = eng.model.num_layers
        attn = "flash_decode_attention" if mode == CacheMode.DENSE else "fused_q_decode_attention"
        want = {"w4_matmul": 7 * L * (29 + (B * Tpad <= 128)), attn: L * 29}
        if mode == CacheMode.COMPRESSED:
            want["prune_quant_pack_kv"] = L       # prefill: a layer's chunk, K and V
        results[label] = {"max_abs_err": err, "tol": REFERENCE_W4_TOL * scale,
                          "greedy_agreement": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
                          "launched": launched, "expected_launches": want,
                          "prefill_w4_launches": prefill_w4}
        ok &= bool(b.isfinite().all()) and err <= REFERENCE_W4_TOL * scale and launched == want
    # the engine's per-slot ticks on the dense cache through kernel 4: three
    # requests over two slots (one waits, a slot idles at -1), each prompt
    # prefilled alone in a 128-token bucket (kernel 5 at prefill)
    Recording, _ = _recording_engine()
    eng = dataclasses.replace(_tiny_engine(CacheMode.DENSE, batch_size=2), prefill_bucket=128)
    rs = np.random.RandomState(5)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ((40, 8), (100, 12), (70, 6))]
    counts0 = _launches()
    cb_runs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        cb = Recording(eng, params, dtype=torch.float32, device=dev,
                       streams=cb_runs["cpu"][0] if dev == "cuda" else None)
        cb.impl.use_pallas = True
        for prompt, m in reqs:
            cb.submit(prompt, m)
        cb_runs[dev] = (cb.run(), cb.logits, cb.decode_steps)
    launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
    _set_launches(counts0)
    toks, lc, steps = cb_runs["cpu"]
    lg = cb_runs["cuda"][1]
    err = max((torch.stack(lc[u]) - torch.stack(lg[u])).abs().max().item() for u in toks)
    scale = max(torch.stack(lc[u]).abs().max().item() for u in toks)
    L = eng.model.num_layers
    want = {"w4_matmul": 7 * L * (steps + len(reqs)), "flash_decode_attention": L * steps}
    results["dense_engine"] = {"requests": len(reqs), "decode_steps": steps,
                               "max_abs_err": err, "tol": REFERENCE_W4_TOL * scale,
                               "launched": launched, "expected_launches": want}
    ok &= err <= REFERENCE_W4_TOL * scale and launched == want
    emit("reference_w4", steps=30, runs=results)
    if not ok:
        raise AssertionError(f"reference_w4: card and CPU disagree or the kernels were "
                             f"not launched as expected: {results}")


INT8_MM_SHAPES = ((8, 4096, 14336), (8, 14336, 4096), (8, 4096, 1024), (300, 4096, 1024),
                  (8, 4096, 32000))   # (rows, in, out): decode and prefill, the head


def phase_reference_w8a8():
    """W8A8 on the card against the CPU.  ``int8_matmul`` (``torch._int_mm``,
    rows padded past 16) on the same int8 codes at Llama-3-8B's and
    Mixtral's projection shapes (decode's 8 rows, a prefill's 300, the
    Mixtral head), the weights row- and column-major: int32 accumulators bit
    for bit with the CPU's int32 matmul; timed at 8 rows beside the W8
    projection (int8 widened to bf16, matmul, scale) of the same shape.
    Then ``reference`` on a tiny f32 Llama in W8A8 (``enable_act_quant(
    quantize_params(...))``) through the dense, masked and q8q4 caches:
    logits within A8_SPREAD_NOTE's bound, the greedy picks as
    A8_PICKS_NOTE allows, each run launching its cache's kernels and no
    other."""
    import torch
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models.quant import (_col_major, enable_act_quant, int8_matmul,
                                                 quantize_params)
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    acc, times = {}, {}
    for M, K, N in INT8_MM_SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
        want = int8_matmul(a, w)
        ac, wc = a.cuda(), w.cuda()
        for layout, wl in (("row", wc), ("col", _col_major(wc))):
            got = int8_matmul(ac, wl)
            acc[f"{M}x{K}x{N}/{layout}"] = bool(torch.equal(got.cpu(), want))
        if M == 8:
            x = torch.randn((M, K), generator=g).to(torch.bfloat16).cuda()
            sc = torch.rand((N,), generator=g).cuda()
            wcol = _col_major(wc)
            calls = {"int8_matmul_col_ms": lambda: int8_matmul(ac, wcol),
                     "int8_matmul_row_ms": lambda: int8_matmul(ac, wc),
                     "w8_proj_ms": lambda: (x @ wc.to(torch.bfloat16)) * sc.to(torch.bfloat16)}
            for fn in calls.values():         # the first call loads cuBLAS's kernels
                fn()
            times[f"{K}x{N}"] = {k: cuda_ms(fn, 20)[0] for k, fn in calls.items()}
    runs, bad = {}, []
    w8a8 = lambda p: enable_act_quant(quantize_params(p))
    cases = ((CacheMode.DENSE, {}), (CacheMode.MASKED, {}),
             (CacheMode.COMPRESSED, {"fused_q_decode_attention": 2 * 39,
                                     "prune_quant_pack_kv": 2}))
    for mode, want in cases:
        fields = phase_reference("q8q4", mode, quant=w8a8)
        runs[mode.value] = dict(fields, expected_launches=want, picks=A8_PICKS_NOTE)
        if fields["launched"] != want or _wide_flips(fields, a8=True):
            bad.append(mode.value)
    emit("reference_w8a8", int32_bit_equal=acc, times_8_rows=times, runs=runs)
    if not all(acc.values()) or bad:
        raise AssertionError(f"reference_w8a8: int32 accumulators {acc}; runs that launched "
                             f"other kernels or flipped picks past the rule: {bad}")


def phase_reference_moe():
    """Mixtral's MLP on a tiny f32 model (4 experts, top-2, capacity factor
    1), card against CPU.  Prefill logits (B=1, a 100-token prompt in a
    128-token bucket, dense cache, every position) within 1e-2 of their
    range: f32, W8 experts (``quantize_params``), W8A8 (A8_SPREAD_NOTE's
    bound) and W4 attention with W8 experts (``quantize_params_w4``: kernel
    5 for the 4 attention projections of each layer, REFERENCE_W4_TOL).
    Then ``reference`` through the q8q4 and bitmap caches (kernels 1 / 9
    and 6) and the dense cache with ``use_pallas`` (kernel 4), and
    ``reference_cb``'s engine at q8q4 (kernels 2, 3 and 9):
    logits within 1e-2 of their range, every greedy pick equal or at a
    near-tie within SWA_TIE_TOL (a routing decision near a tie can move
    between devices), each run launching its kernels and no other (the
    engine kernel 9 at least once a layer for each of its 4 packed prompt
    chunks)."""
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.models.quant import (enable_act_quant, quantize_params,
                                                 quantize_params_w4)
    import numpy as np
    eng = _tiny_engine(CacheMode.DENSE, moe=True)
    base = llama.init_params(eng.model, device="cpu", dtype=torch.float32, seed=4)
    T, Tpad = 100, 128
    toks = torch.zeros((1, Tpad), dtype=torch.int64)
    toks[0, :T] = torch.from_numpy(np.random.RandomState(4).randint(0, 512, T))
    L = eng.model.num_layers
    formats = {"f32": (lambda p: p, 1e-2, {}),
               "w8_experts": (quantize_params, 1e-2, {}),
               "w8a8": (lambda p: enable_act_quant(quantize_params(p)), 1e-2, {}),
               "w4_attention_w8_experts": (quantize_params_w4, REFERENCE_W4_TOL,
                                           {"w4_matmul": 4 * L})}
    prefill = {}
    ok = True
    with torch.inference_mode():
        for label, (fn, tol_frac, want) in formats.items():
            cpu = fn(base)
            runs = [("cpu", cpu), ("cuda", _to_card(cpu))]
            if "act_quant" in cpu:
                runs.append(("cpu", _ulp_up(cpu)))
            counts0 = _launches()
            out = []
            for dev, params in runs:
                impl = make_cache(eng, device=dev)
                logits, _ = llama.prefill(eng.model, params, toks.to(dev),
                                          impl.init(1, torch.float32), impl, T)
                out.append(logits[0, :T].cpu())
            launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
            _set_launches(counts0)
            err, scale = (out[1] - out[0]).abs().max().item(), out[0].abs().max().item()
            tol = tol_frac * scale
            fields = {"max_abs_err": err, "tol": tol, "logits_range": scale,
                      "launched": launched,
                      "expected_launches": want,
                      "argmax_agreement": (out[0].argmax(-1)
                                           == out[1].argmax(-1)).float().mean().item()}
            if len(out) == 3:
                spread = (out[2] - out[0]).abs().max().item()
                tol = max(tol, 3 * spread)
                fields.update(tol=tol, cpu_ulp_spread=spread, tol_rule=A8_SPREAD_NOTE)
            prefill[label] = fields
            ok &= bool(out[1].isfinite().all()) and err <= tol and launched == want
    runs = {}
    cases = (("generator/q8q4", lambda: phase_reference("q8q4", moe=True),
              {"fused_q_decode_attention": 2 * 39, "prune_quant_pack_kv": 2}),
             ("generator/bitmap", lambda: phase_reference("bitmap", moe=True),
              {"fused_sparse_decode_attention": 2 * 39}),
             ("generator/dense_kernel4",
              lambda: phase_reference("q8q4", CacheMode.DENSE, use_pallas=True, moe=True),
              {"flash_decode_attention": 2 * 39}),
             ("engine/q8q4", lambda: phase_reference_cb("q8q4", moe=True), None))
    for label, run, want in cases:
        fields = dict(run(), picks=A8_PICKS_NOTE)
        launched = dict(fields["launched"])
        if want is None:
            # the engine: 2 x its steps and segments; kernel 9 once a layer a
            # packed prompt chunk (4) and once a compaction
            want = {"fused_q_decode_attention_ps": 2 * fields["decode_steps"],
                    "fused_q_segment_attention": 2 * fields["segments"]}
            ok &= launched.pop("prune_quant_pack_kv", 0) >= 2 * 4
        runs[label] = dict(fields, expected_launches=want)
        ok &= launched == want and not _wide_flips(fields)
    emit("reference_moe", experts=4, top_k=2, capacity_factor=1.0, prefill=prefill,
         runs=runs)
    if not ok:
        raise AssertionError(f"reference_moe: card and CPU disagree or the kernels were "
                             f"not launched as expected: {prefill}, {runs}")


# Layers of the host-bound phases: host_split, every serve_cb* phase,
# serve_sp_prefill, serve_w4_*, serve_w8a8_* and harness_predict run
# Llama-3-8B, the serve_swa* and serve_cb_swa* phases Mistral-7B and
# serve_moe_* and serve_cb_moe Mixtral-8x7B at full width and this depth, so
# that the whole run keeps well inside BUDGET_S on a slower host (at full
# depth serve_cb_swa_bitmap took 65.7 s, serve_cb_moe 74.5 s of an 891.5 s
# run on one host, serve_cb_swa_q8q4 38.2 s of a 902.2 s run on another,
# the four serve_swa Generator phases 130.9 s of a 1,019 s run on a third;
# with the SP, PP and training phases serve_cb took 43.0 s, the serve_w4_*
# 47.4 s, the serve_moe_* 62 s, serve_w8a8_* 25.6 s and harness_predict
# 34.0 s of runs of 981-1,014 s).
CUT_LAYERS = 8


def cut_depth(model, params, n=CUT_LAYERS):
    """``model`` and ``params`` (either weight format) cut to their first
    ``n`` layers, full width: views of the stacked layer leaves."""
    import dataclasses
    cut = dict(params, layers={k: v[:n] for k, v in params["layers"].items()})
    return dataclasses.replace(model, num_layers=n), cut


def _pool_bytes(cache):
    """Bytes of a compressed cache's pool and scales (allocated at
    ``max_seq_len``'s chunks)."""
    return sum(cache[k].nbytes for k in ("kv_pool", "kv_scales") if k in cache)


def serve(label, mode, params, prompt, new_tokens, codec="q8q4", use_pallas=False,
          on_cache=None, prune=None, model=None, max_seq_len=1312, chunks_end=2,
          time_prefill=False, graph=None, step_ms=False):
    """One warm-up generation, then the measured one; returns its tokens,
    the launches of every kernel during the measured run (those launched,
    the graph's replays included) and the phase's fields, with the decode's
    path (``graph``: the Generator's choice, the compiled decode on the card
    by default; False the eager loop), its replays and the graph's captured
    launches a replay.  With ``step_ms`` also the device ms of one decode
    step after the run (``_step_device_ms``).  ``use_pallas`` decodes the dense or masked
    cache through its flash-decode kernel; ``on_cache`` is handed the cache
    state the measured run left; ``prune`` defaults to KT_MAG_VT_MAG at
    sparsity 0.7; ``model`` to Llama-3-8B, whose compressed runs end with
    ``chunks_end`` pool chunks.  With ``time_prefill`` a prefill of the
    prompt alone is timed after the run (``prefill_s``)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import EngineConfig, LLAMA3_8B, PruneConfig, PruneMethod
    from mustafar_tpu_torch.runtime.generate import Generator
    model = model or LLAMA3_8B
    if prune is None:
        prune = PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                            v_sparsity=0.7)
    eng = EngineConfig(model=model, cache_mode=mode, prune=prune,
                       max_seq_len=max_seq_len, prefill_bucket=256, chunk_size=256,
                       codec=codec)
    gen = Generator(eng, params, dtype=torch.bfloat16, graph=graph)
    gen.cache_impl.use_pallas = use_pallas
    gen.generate(prompt, 4)                                   # warm-up
    gen.last_cache = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_launches(dict.fromkeys(_counters(), 0))
    t = time.perf_counter()
    out = gen.generate(prompt, new_tokens)
    dt = time.perf_counter() - t
    launches = {k: v for k, v in _launches().items() if v}
    toks = torch.as_tensor(np.stack(out))
    B = toks.shape[0]
    if toks.shape != (B, new_tokens) or toks.min() < 0 or toks.max() >= model.vocab_size:
        raise AssertionError(f"{label}: bad tokens {tuple(toks.shape)}")
    fields = {"batch": B, "prompt": prompt.shape[1], "new_tokens": new_tokens,
              "seconds": dt, "tok_s": B * new_tokens / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "kernel_launches": launches, "decode_path": gen.last_path,
              "replays": gen.last_replays, "captured_launches": gen.last_captured}
    if step_ms:
        fields["step_device_ms"] = _step_device_ms(gen, prompt.shape[1] + new_tokens - 2)
    if mode.value == "compressed":
        fields["codec"] = codec
    else:
        fields["use_pallas"] = use_pallas
    fields["prune"] = {"method": prune.method.value, "k_sparsity": prune.k_sparsity,
                       "v_sparsity": prune.v_sparsity}
    cache = gen.last_cache
    if mode.value == "compressed":
        fields["n_chunks_end"] = cache["nc_host"]
        fields["pool_bytes"] = _pool_bytes(cache)
        if not (cache["nc_host"] == chunks_end
                and bool((cache["n_chunks"] == chunks_end).all())):
            raise AssertionError(f"{label}: expected {chunks_end} pool chunks at the end, "
                                 f"got {cache['nc_host']}")
    from mustafar_tpu_torch.models import llama
    if time_prefill:
        del cache
        gen.last_cache = None
        T = prompt.shape[1]
        toks_in = torch.zeros((B, gen._bucket(T)), dtype=torch.int64)
        toks_in[:, :T] = torch.as_tensor(prompt)
        toks_in = toks_in.cuda()
        with torch.inference_mode():
            fresh = gen.cache_impl.init(B)
            torch.cuda.synchronize()
            t = time.perf_counter()
            llama.prefill(model, params, toks_in, fresh, gen.cache_impl, T, last_only=True)
            torch.cuda.synchronize()
            fields["prefill_s"] = time.perf_counter() - t
        del fresh
        cache = None
    # finite logits on a small prefill through the same engine
    with torch.inference_mode():
        small = torch.as_tensor(prompt[:1, :256]).cuda()
        logits, _ = llama.prefill(model, params, small, gen.cache_impl.init(1),
                                  gen.cache_impl, 256, last_only=True)
    if not bool(logits.isfinite().all()):
        raise AssertionError(f"{label}: non-finite logits")
    if on_cache is not None:
        on_cache(cache)
    del gen, cache
    torch.cuda.empty_cache()
    return toks, launches, fields


def _step_device_ms(gen, pos):
    """Device ms of one decode step of ``gen`` at position ``pos`` over the
    cache its last run left (the step's token column rewritten in place):
    a replay of its graph timed between CUDA events (a replay enqueues in
    microseconds, so the events bracket the card's work), or an eager step
    under a spin kernel long enough to cover its enqueue (``cuda_ms``).
    The replayed and eager launches are taken back out of the counts."""
    import torch
    from mustafar_tpu_torch.models import llama
    counts = _launches()
    with torch.inference_mode():
        if gen.last_path == "graph":
            st = next(iter(gen._static.values()))
            st.pos.fill_(pos)
            ms = cuda_ms(st.graph.run, 20, spin=False)[0]
        else:
            cache = gen.last_cache
            tok = torch.zeros((cache_batch(cache), 1), dtype=torch.int64, device="cuda")
            ms = cuda_ms(lambda: llama.decode_step(gen.cfg, gen.params, tok, cache,
                                                   gen.cache_impl, pos),
                         5, spin_cycles=EAGER_STEP_SPIN)[0]
    torch.cuda.synchronize()
    _set_launches(counts)
    return ms


EAGER_STEP_SPIN = 200_000_000   # ~100 ms of the card's clock: an eager 32-layer step's enqueue


def cache_batch(cache):
    """The batch of a cache state."""
    return (cache["k_win"] if "k_win" in cache else cache["k"]).shape[1]


def _step_parts(params):
    """At B=8: the device ms of one layer's seven projections (``proj``: W8
    widened to bf16, then matmul and scale; W4 through its kernel), each
    layer timed alone under the spin kernel (a layer's launches enqueue
    within it, so the events read device time) and averaged over the
    params' layers (32, or CUT_LAYERS); the host us to enqueue one layer's
    projections; the LM head's device ms."""
    import torch
    from mustafar_tpu_torch.config import LLAMA3_8B as cfg
    from mustafar_tpu_torch.models.llama import _lm_head
    from mustafar_tpu_torch.models.quant import proj
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    h = torch.randn((8, 1, cfg.hidden_size), generator=g, device="cuda").to(torch.bfloat16)
    hi = torch.randn((8, 1, cfg.intermediate_size), generator=g,
                     device="cuda").to(torch.bfloat16)
    hq = torch.randn((8, 1, cfg.q_dim), generator=g, device="cuda").to(torch.bfloat16)
    layers = params["layers"]

    def layer(li):
        lp = {name: leaf[li] for name, leaf in layers.items()}
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            proj(h, lp, name)
        proj(hq, lp, "wo")
        proj(hi, lp, "w_down")

    with torch.inference_mode():
        layer(0)
        _lm_head(cfg, params, h)
        torch.cuda.synchronize()
        n = len(next(iter(layers.values())))
        layer_ms = sum(cuda_ms(lambda li=li: layer(li), 2)[0] for li in range(n)) / n
        layer_host_us = host_us(lambda: layer(0), 10)
        head_ms = cuda_ms(lambda: _lm_head(cfg, params, h), 5)[0]
    return layer_ms, layer_host_us, head_ms


def phase_decode_split(params, kernel_ms, q8q4_s, dense_s, new_tokens):
    """Device time of the W8 decode step's big parts, each timed alone: the
    seven projections of a layer, the LM head and the attention kernel,
    beside the wall time per generated token of the two serve runs."""
    from mustafar_tpu_torch.config import LLAMA3_8B as cfg
    w8_layer_ms, layer_host_us, head_ms = _step_parts(params)
    parts_ms = cfg.num_layers * (w8_layer_ms + kernel_ms) + head_ms
    emit("decode_split", w8_layer_ms=w8_layer_ms, w8_layer_host_us=layer_host_us,
         lm_head_ms=head_ms,
         attn_kernel_ms=kernel_ms, w8_head_attention_ms_per_step=parts_ms,
         q8q4_wall_ms_per_token=q8q4_s / new_tokens * 1e3,
         dense_wall_ms_per_token=dense_s / new_tokens * 1e3)


def phase_decode_split_w4(params, attn_ms, wall_s, new_tokens, model=None):
    """The W4 decode step's parts, as ``decode_split``: a layer's seven W4
    projections through kernel 5, the W8 LM head, and per cache its
    attention kernel (q8q4 kernel 1 and bitmap kernel 6 at one chunk and a
    full window; the dense twin's kernel 4 at pos 599, the run's last
    step), at ``model``'s depth (default Llama-3-8B's), beside each
    ``serve_w4_*`` run's wall time per token."""
    from mustafar_tpu_torch.config import LLAMA3_8B
    cfg = model or LLAMA3_8B
    w4_layer_ms, layer_host_us, head_ms = _step_parts(params)
    parts = {c: cfg.num_layers * (w4_layer_ms + ms) + head_ms for c, ms in attn_ms.items()}
    emit("decode_split_w4", w4_layer_ms=w4_layer_ms, w4_layer_host_us=layer_host_us,
         lm_head_ms=head_ms,
         attn_kernel_ms=attn_ms, w4_head_attention_ms_per_step=parts,
         wall_ms_per_token={c: t / new_tokens * 1e3 for c, t in wall_s.items()})


GRAPH_CASES = {"q8q4": ("COMPRESSED", "q8q4", "fused_q_decode_attention"),
               "bitmap": ("COMPRESSED", "bitmap", "fused_sparse_decode_attention"),
               "dense": ("DENSE", "q8q4", None)}


def phase_serve_graph(label, params, prompt, new, graphed, model_note):
    """The compiled decode against the eager loop on Llama-3-8B at full
    width and depth, B=8, ``prompt`` (300) + ``new`` (300): for each case of
    ``graphed`` (its graphed run: ``serve``'s tokens, launches and fields,
    with the step's device ms) the same run again through the eager loop
    (``graph=False``).  The tokens must be equal; the graphed run's decode
    kernel launches must be its graph's captured launches x replays and the
    gate (layers x steps), the eager run's the same counts.  Prints each
    case's wall ms per token, a step's device ms, replays and captured
    launches, graphed and eager.  The dense twin's graphed step attends all
    max_seq_len (1,312) rows masked by the position, as the JAX package's
    static-shape decode does; its eager step the rows before it."""
    import torch
    from mustafar_tpu_torch.config import CacheMode, LLAMA3_8B
    steps = new - 1
    gate = LLAMA3_8B.num_layers * steps
    cases = {}
    for case, (toks, launches, fields) in graphed.items():
        mode, codec, attn = GRAPH_CASES[case]
        etoks, elaunches, efields = serve(f"{label}_{case}_eager", getattr(CacheMode, mode),
                                          params, prompt, new, codec=codec, graph=False,
                                          step_ms=True)
        replayed = {k: n * fields["replays"] for k, n in fields["captured_launches"].items()}
        want = {attn: gate} if attn else {}
        got = {attn: launches.get(attn, 0)} if attn else {}
        cases[case] = {
            "tokens_equal": bool(torch.equal(toks, etoks)),
            "wall_ms_per_token": {"graph": fields["seconds"] / new * 1e3,
                                  "eager": efields["seconds"] / new * 1e3},
            "step_device_ms": {"graph": fields["step_device_ms"],
                               "eager": efields["step_device_ms"]},
            "decode_path": {"graph": fields["decode_path"], "eager": efields["decode_path"]},
            "replays": fields["replays"], "captured_launches": fields["captured_launches"],
            "replayed_launches": replayed, "launches": {"graph": launches, "eager": elaunches},
            "gate": want, "peak_mem_gib": {"graph": fields["peak_mem_gib"],
                                           "eager": efields["peak_mem_gib"]}}
        c = cases[case]
        if not (c["tokens_equal"] and fields["decode_path"] == "graph"
                and efields["decode_path"] == "eager" and got == want
                and (not attn or replayed.get(attn) == gate)
                and launches == elaunches and fields["replays"] == steps):
            raise AssertionError(f"{label} {case}: graphed and eager runs differ: {c}")
    emit(label, model=model_note, batch=prompt.shape[0], prompt=prompt.shape[1],
         new_tokens=new, cases=cases)


def serve_cb_requests(model, first8=False):
    """serve_cb's stream: 16 requests of 200-1,500 prompt tokens and 32-96
    new ones (``RandomState(1)``), one of 8,000 + 64 submitted third; with
    ``first8`` the first 8 without the 8,000-token one."""
    import numpy as np
    rs = np.random.RandomState(1)
    reqs = [(rs.randint(1, model.vocab_size, size=rs.randint(200, 1501)),
             int(rs.randint(32, 97))) for _ in range(16)]
    reqs.insert(2, (rs.randint(1, model.vocab_size, size=8000), 64))
    if first8:
        reqs = [r for r in reqs if len(r[0]) != 8000][:8]
    return reqs


def phase_serve_cb(params, codec="q8q4", w4=False, first8=False, beside=None, prune=None,
                   model=None, eager_too=False):
    """Continuous batching at full Llama-3-8B width and depth (or
    ``model``'s: Llama-3-8B cut in depth by ``cut_depth``, as ``serve_cb``
    runs, Mistral-7B with
    its window as ``serve_cb_swa_<codec>``, Mixtral-8x7B as
    ``serve_cb_moe``): 8 slots, 17
    requests (16 with prompts of 200-1,500 tokens and 32-96 new tokens,
    plus one of 8,000 prompt tokens submitted third), chunked prefill with
    interleaved admission, ``codec`` at 0.7.  Every decode step must launch
    the codec's per-slot kernel once a layer, every segment its segment
    kernel once a layer, and no other kernel may run; every request's first
    token must equal a batch-1 chunked Generator's on the same prompt.
    A quant codec's engine packs through kernel 9, K and V in one launch:
    once a layer for every chunk a prompt packs (a segment packs its layer's
    chunk) and once for every compaction (one ``compact_slots`` call packs
    every layer of all the slots it names).  With ``first8``:
    the first 8 requests of that stream without the 8,000-token one.  With
    ``w4`` (W4 params; implies ``first8``): the W4 kernel 7 times a layer in
    every decode step (a segment's 256 tokens take the dequant route).
    ``beside``: fields of another run printed with this one.  ``prune``
    (default KT_MAG_VT_MAG at 0.7): with an Opa method the run is
    ``serve_cb_opa``, and the scored buffers must be live at its end (the
    per-slot kernel's window probabilities, or K's scores, reached the
    cache).  The engine decodes and admits through its CUDA graphs (the
    card's default: the per-slot tick, and one captured segment replayed
    for every admission segment); with ``eager_too`` the same requests run
    again through the eager engine (``graph=False``), whose tokens and
    launches must equal the graphed run's, its tick times (a segment +
    decode tick's among them) printed beside.  Returns the launches and the
    run's peak memory and pool bytes."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.runtime.generate import Generator
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    model = model or LLAMA3_8B
    if prune is None:
        prune = PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                            v_sparsity=0.7)
    eng = EngineConfig(model=model, cache_mode=CacheMode.COMPRESSED, prune=prune,
                       max_seq_len=8448, prefill_bucket=256, chunk_size=256,
                       codec=codec, batch_size=8, chunked_prefill=True)
    reqs = serve_cb_requests(model, first8=w4 or first8)
    warm = ContinuousBatchingEngine(eng, params)
    for p, _ in reqs[:2]:
        warm.submit(p[:300], 4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated() / 2 ** 30     # the weights, no engine

    class Timed(ContinuousBatchingEngine):
        """Wall time of each tick by what it ran (a tick that decodes ends
        in the device read of its tokens, so its time includes its work)."""
        split = {"segment+decode": [], "decode": [], "segment": []}

        def tick(self):
            seg0, dec0, t0 = self.segments, self.decode_steps, time.perf_counter()
            super().tick()
            kind = ("segment+" if self.segments > seg0 else "") + \
                ("decode" if self.decode_steps > dec0 else "")
            self.split[kind.rstrip("+")].append(time.perf_counter() - t0)

    cb = Timed(eng, params)
    compactions = [0]
    compact_slots = cb.impl.compact_slots

    def counted(state, do):
        compactions[0] += any(do)
        return compact_slots(state, do)

    cb.impl.compact_slots = counted
    uids = [cb.submit(p, m) for p, m in reqs]
    _set_launches(dict.fromkeys(_counters(), 0))
    t = time.perf_counter()
    outs = cb.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pool_bytes = _pool_bytes(cb.cache)
    # the slot bookkeeping ran in the native core, which admitted and retired
    # every request and refused none
    from mustafar_tpu_torch.native import NativeSlotScheduler
    native = cb.core.stats() if isinstance(cb.core, NativeSlotScheduler) else None
    native_want = {"admitted": len(reqs), "finished": len(reqs), "rejected": 0}
    L = model.num_layers
    generated = sum(len(outs[u]) for u in uids)
    want = dict.fromkeys(launches, 0)
    want[_meta(codec, "decode_ps")[0]] = L * cb.decode_steps
    want[_meta(codec, "segment")[0]] = L * cb.segments
    prompt_chunks = sum(max(len(p) - 32, 0) // 256 for p, _ in reqs)
    if codec in QUANT_BITS:          # every segment stages its layer's pack
        want["prune_quant_pack_kv"] = L * cb.segments + compactions[0]
    if w4:
        want["w4_matmul"] = 7 * L * cb.decode_steps
    seg_expected = sum(-(-len(p) // 256) for p, _ in reqs)
    bad = [u for u, (p, m) in zip(uids, reqs)
           if len(outs[u]) != m or min(outs[u]) < 0 or max(outs[u]) >= model.vocab_size]
    # first tokens against a batch-1 chunked Generator (not counted above)
    gen = Generator(eng, params)
    first_equal = [int(gen.generate(p[None], 1)[0][0]) == int(outs[u][0])
                   for u, (p, _) in zip(uids, reqs)]
    counts = {"ticks": cb.ticks, "decode_steps": cb.decode_steps,
              "segments": cb.segments, "prompt_chunks": prompt_chunks,
              "compactions": compactions[0],
              "tick_ms": {k: {"n": len(v), "mean": 1e3 * sum(v) / max(len(v), 1),
                              "total_s": sum(v)} for k, v in Timed.split.items()}}
    scores = {k: float(cb.cache[k].abs().sum()) for k in cb.impl.score_keys}
    counts["decode_path"], counts["replays"] = cb.decode_path, cb.replays
    counts["segment_replays"] = cb.segment_replays
    del gen, cb
    torch.cuda.empty_cache()
    eager = None
    if eager_too:
        class TimedEager(Timed):
            split = {"segment+decode": [], "decode": [], "segment": []}

        ecb = TimedEager(eng, params, graph=False)
        euids = [ecb.submit(p, m) for p, m in reqs]
        _set_launches(dict.fromkeys(_counters(), 0))
        t = time.perf_counter()
        eouts = ecb.run()
        torch.cuda.synchronize()
        edt = time.perf_counter() - t
        elaunches = _launches()
        eager = {"decode_path": ecb.decode_path, "seconds": edt,
                 "tokens_equal": all(np.array_equal(outs[u], eouts[e])
                                     for u, e in zip(uids, euids)),
                 "launches_equal": elaunches == launches,
                 "tick_ms": {k: {"n": len(v), "mean": 1e3 * sum(v) / max(len(v), 1),
                                 "total_s": sum(v)} for k, v in TimedEager.split.items()}}
        _set_launches(launches)
        del ecb
        torch.cuda.empty_cache()
    label = ("serve_cb_w4" if w4 else "serve_cb_opa" if scores
             else "serve_cb_moe" if model.num_experts
             else "serve_cb_swa_" + codec.replace("-", "_") if model.sliding_window
             else "serve_cb" if codec == "q8q4" else "serve_cb_" + codec.replace("-", "_"))
    window = f", window {model.sliding_window}" if model.sliding_window else ""
    emit(label, model=f"{model.name} x{L}L{window}, {'W4' if w4 else 'W8'} (random, seed 0)",
         codec=codec, slots=8,
         requests=len(reqs), prompt_tokens=sum(len(p) for p, _ in reqs),
         generated_tokens=generated, seconds=dt, tok_s=generated / dt,
         peak_mem_gib=peak, mem_before_gib=mem_before, pool_bytes=pool_bytes, **counts,
         launches=launches, prune={"method": prune.method.value,
                                   "k_sparsity": prune.k_sparsity,
                                   "v_sparsity": prune.v_sparsity},
         score_sums=scores, native_core=native,
         expected_launches=want, first_token_equal=sum(first_equal), eager=eager,
         **(beside or {}))
    if eager is not None and not (eager["tokens_equal"] and eager["launches_equal"]
                                  and counts["decode_path"] == "graph"
                                  and counts["segment_replays"] == counts["segments"] - 1):
        raise AssertionError(f"{label}: the graphed engine ({counts['decode_path']}) and "
                             f"the eager one disagree: {eager}")
    if native != native_want:
        raise AssertionError(f"{label}: the native slot core's stats {native}, expected "
                             f"{native_want} (None: the core was not built)")
    if scores and not all(scores.values()):
        raise AssertionError(f"{label}: the scored buffers are empty at the end: {scores}")
    if bad or launches != want or counts["segments"] != seg_expected:
        raise AssertionError(f"{label}: bad outputs {bad}, launches {launches} "
                             f"(expected {want}), segments {counts['segments']} "
                             f"(expected {seg_expected})")
    if not all(first_equal):
        raise AssertionError(f"{label}: first tokens differ from the batch-1 "
                             f"chunked Generator for requests "
                             f"{[u for u, ok in zip(uids, first_equal) if not ok]}")
    return launches, {"peak_mem_gib": peak, "pool_bytes": pool_bytes}


def phase_serve_chunked(params):
    """Generator with chunked prefill at full width: B=4, prompt 2,000 (8
    segments), 64 new tokens; prefill through the segment kernel, decode
    through the uniform kernel.  Graphed (the card's default: one captured
    segment replayed for every segment, and the decode step's graph)
    against eager (``graph=False``): tokens equal; each one's prefill alone
    (``generate(prompt, 1)``: the segments and the first pick) timed on the
    wall and on the device (torch.profiler), with the kernels it ran; the
    segment graph's capture time and the memory its pool took; launch gates
    as captured x replays."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.runtime.generate import Generator
    eng = EngineConfig(model=LLAMA3_8B, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.7, v_sparsity=0.7),
                       max_seq_len=2304, prefill_bucket=256, chunk_size=256,
                       codec="q8q4", chunked_prefill=True)
    prompt = np.random.RandomState(3).randint(1, LLAMA3_8B.vocab_size, (4, 2000))
    new = 64
    L = LLAMA3_8B.num_layers
    want = {"fused_q_decode_attention": L * (new - 1),
            "fused_q_segment_attention": L * 2048 // 256}
    counts0 = _launches()
    runs, toks = {}, {}
    for graph in (True, False):
        gen = Generator(eng, params, graph=graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _set_launches(dict.fromkeys(_counters(), 0))
        t = time.perf_counter()
        out = gen.generate(prompt, new)          # graphed: both graphs captured here
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = _launches()
        launches = {name: counts[name] for name in want}
        toks[graph] = np.stack(out)
        run = {"path": gen.last_path, "seconds": dt, "tok_s": toks[graph].size / dt,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "n_chunks_end": gen.last_cache["nc_host"], "launches": launches,
               "replays": gen.last_replays, "prefill_replays": gen.last_prefill_replays}
        if graph:
            (static,) = gen._static.values()
            run["segment_graph"] = {"capture_s": static.segment.graph.capture_s,
                                    "capture_mib": static.segment.graph.capture_bytes / 2 ** 20,
                                    "captured_launches": static.segment.graph.captured}
        # the prefill alone (the run above warmed it), every segment
        # replayed on the graphed path
        t = time.perf_counter()
        gen.generate(prompt, 1)
        enqueue = time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        # the card's activity alone: ~46,500 kernels, whose host ops the
        # eager path's trace would add ~100,000 more of
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gen.generate(prompt, 1)
            torch.cuda.synchronize()
        events = prof.key_averages()
        run["prefill"] = {
            "enqueue_ms": 1e3 * enqueue, "wall_ms": 1e3 * wall,
            "device_ms": sum(e.self_device_time_total for e in events
                             if e.device_type == DeviceType.CUDA) / 1e3,
            "device_kernels": sum(e.count for e in events
                                  if e.device_type == DeviceType.CUDA),
            "graph_launches": sum(e.count for e in events
                                  if e.key.startswith("cudaGraphLaunch"))}
        runs["graph" if graph else "eager"] = run
        del gen
        torch.cuda.empty_cache()
    _set_launches(counts0)
    equal = bool(np.array_equal(toks[True], toks[False]))
    emit("serve_chunked", batch=4, prompt=2000, new_tokens=new, expected_launches=want,
         tokens_equal_eager=equal, **runs)
    bad = [k for k, r in runs.items() if r["launches"] != want or r["n_chunks_end"] != 7]
    if toks[True].shape != (4, new) or bad or not equal \
            or runs["graph"]["path"] != "graph" or runs["graph"]["prefill_replays"] != 7:
        raise AssertionError(f"serve_chunked: tokens {toks[True].shape}, equal to the "
                             f"eager run's {equal}; runs {bad} launched other than "
                             f"{want}: {runs}")


def phase_slot_core():
    """The slot bookkeeping's host cost a tick, the native core against
    ``PySlotScheduler``, on the engine's calls (one ``fill`` a tick, a
    ``commit`` a busy slot): 8 slots, 64 requests of 300 + 64 (the least
    of 3 runs)."""
    from mustafar_tpu_torch.native import NativeSlotScheduler, PySlotScheduler
    us, stats = {}, {}
    for cls in (NativeSlotScheduler, PySlotScheduler):
        best = float("inf")
        for _ in range(3):
            core = cls(8, 1312)
            for uid in range(1, 65):
                core.submit(uid, 300, 64)
            live, ticks = set(), 0
            t = time.perf_counter()
            while core.num_queued or live:
                live.update(slot for slot, *_ in core.fill())
                live -= {slot for slot in list(live) if core.commit(slot, False) == 1}
                ticks += 1
            best = min(best, (time.perf_counter() - t) / ticks * 1e6)
        us[cls.__name__], stats[cls.__name__] = best, core.stats()
    emit("slot_core", slots=8, requests=64, ticks=ticks, us_per_tick=us, stats=stats)
    want = {"admitted": 64, "finished": 64, "rejected": 0}
    if any(v != want for v in stats.values()):
        raise AssertionError(f"slot_core: stats {stats}, expected {want} in each")


def phase_host_split(params, model=None):
    """Host or device: one chunked-prefill segment (B=1 after 4 packed
    chunks; it packs a fifth) at q8q4, bitmap and bitmap-q8, eager and as a
    replay of the segment graph (``StaticSegment``; its capture time and
    pool beside, and its cache state after the segments bit-equal to the
    eager one's), one pack of a
    chunk's K and V (B=1, 8 kv heads: what a segment does per layer) at
    each, one decode tick of the engine with 8 active slots (q8q4), and one
    of the q8q4 and of the bitmap engine with 8 active slots, one of them
    8,000 tokens long (31 pool chunks: the per-slot kernels' longest slot),
    each timed three ways: the host's time to enqueue it, the wall time
    until the card is done, and the device time of its kernels with the
    number of kernels launched (torch.profiler).  ``model`` (default
    Llama-3-8B) may be cut in depth (``cut_depth``): every number is then
    that depth's."""
    import dataclasses
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.runtime.generate import StaticSegment
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    model = model or LLAMA3_8B
    eng = EngineConfig(model=model, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.7, v_sparsity=0.7),
                       max_seq_len=2304, prefill_bucket=256, chunk_size=256,
                       codec="q8q4", batch_size=8, chunked_prefill=True)

    def measure(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        enqueue = time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # device rows only: an op's row also counts the kernels it launched
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        # cudaLaunchKernel, and cudaLaunchKernelExC for cluster launches; a
        # graph's kernels go in one cudaGraphLaunch, and show on the device
        launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
        return {"enqueue_ms": 1e3 * enqueue, "wall_ms": 1e3 * wall,
                "device_ms": device_us / 1e3, "kernels_launched": launches,
                "graph_launches": sum(e.count for e in events
                                      if e.key.startswith("cudaGraphLaunch")),
                "device_kernels": sum(e.count for e in events
                                      if e.device_type == DeviceType.CUDA)}

    toks = torch.as_tensor(np.random.RandomState(4).randint(1, 500, (1, 2048)),
                           device="cuda")
    kv = torch.randn((1, model.num_kv_heads, 256, 128), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4))
    kv = kv.to(torch.bfloat16)
    segments, graphed, packs = {}, {}, {}
    with torch.inference_mode():
        for codec in ("q8q4", "bitmap", "bitmap-q8"):
            impl = make_cache(dataclasses.replace(eng, codec=codec))
            sub = impl.init(1)
            seg = [0]

            def segment():
                s = seg[0]
                llama.prefill_segment(model, params, toks[:, s * 256:(s + 1) * 256],
                                      sub, impl, s * 256, 2000)
                seg[0] += 1

            for _ in range(4):
                segment()
            segments[codec] = measure(segment)   # segment 4; the profiled one is 5
            # the same segments through the segment graph (StaticSegment: the
            # first captures it, every later one replays it)
            st = StaticSegment(model, params, impl.init(1), impl, 1, torch.device("cuda"),
                               True)
            gseg = [0]

            def graphed_segment():
                s = gseg[0]
                st.step(toks[:, s * 256:(s + 1) * 256], s * 256, 2000)
                gseg[0] += 1

            for _ in range(4):
                graphed_segment()
            graphed[codec] = dict(measure(graphed_segment),
                                  capture_s=st.graph.capture_s,
                                  capture_mib=st.graph.capture_bytes / 2 ** 20,
                                  captured_launches=st.graph.captured,
                                  state_equal_eager=all(
                                      torch.equal(v, st.cache[k]) for k, v in sub.items()
                                      if torch.is_tensor(v)))
            packs[codec] = measure(lambda: impl._pack(kv, kv))
            del sub, st
        cb = ContinuousBatchingEngine(eng, params)
        rs = np.random.RandomState(5)
        for _ in range(8):
            cb.submit(rs.randint(1, 500, size=300), 64)
        while cb._admissions or cb.core.num_queued:
            cb.tick()
        tick_split = dict(measure(cb.tick), decode_path=cb.decode_path)
        del cb
        ticks_long = {}
        for codec in ("q8q4", "bitmap"):
            cb = ContinuousBatchingEngine(dataclasses.replace(eng, codec=codec,
                                                              max_seq_len=8448), params)
            rs = np.random.RandomState(6)
            for n in (8000, 300, 700, 1500, 450, 1000, 1200, 600):
                cb.submit(rs.randint(1, 500, size=n), 200)
            while cb._admissions or cb.core.num_queued:
                cb.tick()
            cb.tick()
            ticks_long[codec] = dict(measure(cb.tick), decode_path=cb.decode_path)
            del cb
    torch.cuda.empty_cache()
    emit("host_split", model=f"{model.name} x{model.num_layers}L, W8 (random, seed 0)",
         segment_b1=segments["q8q4"], segment_b1_bitmap=segments["bitmap"],
         segment_b1_bitmap_q8=segments["bitmap-q8"], segment_b1_graph=graphed,
         pack_kv_b1=packs,
         decode_tick_b8=tick_split, decode_tick_b8_long=ticks_long["q8q4"],
         decode_tick_b8_bitmap_long=ticks_long["bitmap"])
    bad = [codec for codec, r in graphed.items() if not r["state_equal_eager"]]
    if bad:
        raise AssertionError(f"host_split: the graphed segments left another cache state "
                             f"than the eager ones at {bad}")


def serve_w4(entries, prompt, new):
    """The W4 path at full Llama-3-8B width (``init_params_w4``, seed 0, its
    32 layers made), run at 8 of them (CUT_LAYERS; host-bound):
    ``serve_w4_dense`` (the dense cache through kernel 4), ``serve_w4_q8q4``
    and ``serve_w4_bitmap``, B=8, 300 + 300 tokens; every decode step
    launches kernel 5 seven times a layer and the cache's decode kernel
    once a layer, prefill (4,096 tokens) takes the dequant route; first
    tokens equal the dense run's.  Then ``decode_split_w4`` and
    ``serve_cb_w4`` at the same depth."""
    import torch
    from mustafar_tpu_torch.config import CacheMode, LLAMA3_8B
    from mustafar_tpu_torch.models.quant import init_params_w4, weight_bytes
    t = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = init_params_w4(LLAMA3_8B, g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights_gib = weight_bytes(params) / 2 ** 30
    graphed = {"q8q4": serve("serve_graph_w4_q8q4", CacheMode.COMPRESSED, params, prompt,
                             new, step_ms=True)}
    phase_serve_graph("serve_graph_w4", params, prompt, new, graphed,
                      "llama-3-8b x32L, W4 (random, seed 0)")
    m, params = cut_depth(LLAMA3_8B, params)
    L = m.num_layers
    steps = new - 1
    runs = (("serve_w4_dense", CacheMode.DENSE, "q8q4", "flash_decode_attention"),
            ("serve_w4_q8q4", CacheMode.COMPRESSED, "q8q4", "fused_q_decode_attention"),
            ("serve_w4_bitmap", CacheMode.COMPRESSED, "bitmap", "fused_sparse_decode_attention"))
    dense_toks, wall = None, {}
    for label, mode, codec, attn in runs:
        toks, launches, fields = serve(label, mode, params, prompt, new, codec=codec,
                                       use_pallas=mode == CacheMode.DENSE, model=m)
        if dense_toks is None:
            dense_toks = toks
        want = {"w4_matmul": 7 * L * steps, attn: L * steps}
        if mode == CacheMode.COMPRESSED and codec in QUANT_BITS:
            want["prune_quant_pack_kv"] = serve_packs(m)
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, model=f"{m.name} x{L}L (CUT_LAYERS), W4 (random, seed 0; 32 layers "
                          "made)",
             weights_gib=weights_gib, weights_init_s=init_s,
             decode_steps=steps, expected_launches=want, first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(), **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal the dense run's: {first_equal}")
        wall[label.removeprefix("serve_w4_")] = fields["seconds"]
        if mode == CacheMode.DENSE:
            entries[("dense", "decode")]["launches"] = launches[attn]
        elif codec == "q8q4":
            entries[("w4", "matmul")]["launches"] = launches["w4_matmul"]
    phase_decode_split_w4(params, {"q8q4": entries[("q8q4", "decode")]["kernel_ms"],
                                   "bitmap": entries[("bitmap", "decode")]["kernel_ms"],
                                   "dense": entries[("dense", "decode")]["kernel_ms"]},
                          wall, new, m)
    phase_serve_cb(params, "bitmap", w4=True, model=m, eager_too=True)
    del params
    torch.cuda.empty_cache()


MASKED_NEW = 100   # new tokens of the masked serve phases (their exits cross 3 groups)


def serve_opa(entries, params, prompt, new, dense_toks):
    """The masked cache and Opa pruning at full width and depth (B=8, prompt
    300, first tokens = serve_dense's): ``serve_masked`` (the EngineConfig
    defaults: masked cache, KT_MAG_VT_MAG at 0.5, plain route: no kernel)
    and ``serve_masked_opa`` (KT_MAG_VC_OPA at 0.7, use_pallas: kernel 4
    with its (m, l) 32 x 99 times), MASKED_NEW new tokens each;
    ``serve_opa_q8q4`` and ``serve_opa_bitmap`` (KT_MAG_VT_OPA at 0.7,
    ``new`` tokens, a compaction by score on the way: kernel 1 or 6 with
    its window probabilities 32 x 299 times; kernel 9 with V's scores 32 +
    1 times, K and V in one launch).  Each run's V scores must be live at
    its end (the options' results reached the cache).  Fills the options'
    launches in the kernels line."""
    from mustafar_tpu_torch.config import CacheMode, PruneConfig, PruneMethod
    opa = PruneConfig(method=PruneMethod.KT_MAG_VC_OPA, k_sparsity=0.7, v_sparsity=0.7)
    vt_opa = PruneConfig(method=PruneMethod.KT_MAG_VT_OPA, k_sparsity=0.7, v_sparsity=0.7)
    masked_steps, steps = 32 * (MASKED_NEW - 1), 32 * (new - 1)
    runs = (("serve_masked", CacheMode.MASKED, "q8q4", False, PruneConfig(), MASKED_NEW,
             {}),
            ("serve_masked_opa", CacheMode.MASKED, "q8q4", True, opa, MASKED_NEW,
             {"flash_decode_attention": masked_steps}),
            ("serve_opa_q8q4", CacheMode.COMPRESSED, "q8q4", False, vt_opa, new,
             {"fused_q_decode_attention": steps, "prune_quant_pack_kv": serve_packs()}),
            ("serve_opa_bitmap", CacheMode.COMPRESSED, "bitmap", False, vt_opa, new,
             {"fused_sparse_decode_attention": steps}))
    for label, mode, codec, use_pallas, prune, n_new, want in runs:
        scores = {}
        toks, launches, fields = serve(
            label, mode, params, prompt, n_new, codec=codec, use_pallas=use_pallas,
            prune=prune, on_cache=lambda c: scores.update(
                {k: float(c[k].abs().sum()) for k in ("k_score", "v_score") if k in c}))
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, decode_steps=n_new - 1, expected_launches=want,
             first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks[:, :n_new]).float().mean().item(),
             score_sums=scores, **fields)
        scored = prune.method.v_policy in ("token_opa", "channel_opa")
        if launches != want or not first_equal or (scored and not scores.get("v_score")):
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal the dense run's: {first_equal}, scores "
                                 f"{scores}")
        note = f"{label}: every launch with the option (V scored by {prune.method.value})"
        if label == "serve_masked_opa":
            opt = entries[("dense", "decode")]["options"]["return_norm"]
            opt.update(launches=launches["flash_decode_attention"], launches_note=note)
        elif label == "serve_opa_q8q4":
            opt = entries[("q8q4", "decode")]["options"]["return_win_probs"]
            opt.update(launches=launches["fused_q_decode_attention"], launches_note=note)
            opt = entries[("q8q4", "pack")]["options"]["score"]
            opt.update(launches=launches["prune_quant_pack_kv"],
                       launches_note=f"{label}: V ranked by its scores, K by |x|, one "
                                     f"launch a layer at prefill and one compaction")
        elif label == "serve_opa_bitmap":
            opt = entries[("bitmap", "decode")]["options"]["return_win_probs"]
            opt.update(launches=launches["fused_sparse_decode_attention"],
                       launches_note=note)


def serve_cb_opa(entries, params, model, reference_launches):
    """``serve_cb_opa``: the engine at full Llama-3-8B width (``model``, cut
    in depth by ``cut_depth``) under KT_MAG_VT_OPA at 0.7 (q8q4,
    ``serve_cb``'s first 8 requests): kernel 2 with its window
    probabilities a layer a decode step, kernel 3 a layer a segment,
    kernel 9 at serve_cb's packing counts (V ranked by its
    scores), first tokens equal to a batch-1 chunked Generator's under the
    same method, V's scores live at the end.  Fills the per-slot kernels'
    option launches in the kernels line (kernel 7's from
    ``reference_opa_cb``'s bitmap engine on the card)."""
    from mustafar_tpu_torch.config import PruneConfig, PruneMethod
    vt_opa = PruneConfig(method=PruneMethod.KT_MAG_VT_OPA, k_sparsity=0.7, v_sparsity=0.7)
    launches, _ = phase_serve_cb(params, "q8q4", first8=True, prune=vt_opa, model=model,
                                 eager_too=True)
    name = "fused_q_decode_attention_ps"
    entries[("q8q4", "decode_ps")]["options"]["return_win_probs"].update(
        launches=launches[name],
        launches_note="serve_cb_opa: every launch with the option (V scored by "
                      "kt_mag_vt_opa)")
    name = "fused_sparse_decode_attention_ps"
    entries[("bitmap", "decode_ps")]["options"]["return_win_probs"].update(
        launches=reference_launches["kt_mag_vt_opa/bitmap"][name],
        launches_note="reference_opa_cb's bitmap engine under kt_mag_vt_opa on the card "
                      "(tiny model): every launch with the option")


def serve_packs(model=None):
    """Kernel 9 launches of a ``serve`` run of a quant codec on ``model``
    (default Llama-3-8B): one a layer for prefill's chunk (300 - 32 tokens;
    K and V of every chunk of the layer's prompt in one launch) and one for
    the compaction (after decode step 244; every layer's K and V in one
    launch)."""
    from mustafar_tpu_torch.config import LLAMA3_8B
    return (model or LLAMA3_8B).num_layers + 1


SWA_B, SWA_PROMPT, SWA_NEW = 4, 4400, 300


def phase_serve_swa_chunked(params, m, prompt, q8q4_toks, new=64):
    """The chunked Generator on Mistral-7B with its window at serve_swa's
    width and depth: B=4, serve_swa's 4,400-token prompt in 18 segments
    (segment 17's rows see chunk 0 none and chunk 1 past their own edge),
    ``new`` tokens; q8q4.  Graphed (the windowed segment captured once and
    replayed for the other 17) and eager: tokens equal.  Kernel 3 with the
    window once a layer a segment, kernel 1 once a layer a decode step,
    kernel 9 once a layer a segment (its staged pack) and nothing else, in
    each; tokens beside serve_swa_q8q4's (monolithic banded prefill)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, EngineConfig, PruneConfig, PruneMethod
    from mustafar_tpu_torch.models.llama import n_segments
    from mustafar_tpu_torch.runtime.generate import Generator
    T = prompt.shape[1]
    eng = EngineConfig(model=m, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                                         v_sparsity=0.7),
                       max_seq_len=-(-T // 256) * 256 + new, prefill_bucket=256,
                       chunk_size=256, codec="q8q4", chunked_prefill=True)
    L = m.num_layers
    want = {"fused_q_decode_attention": L * (new - 1),
            "fused_q_segment_attention": L * n_segments(T, 256),
            "prune_quant_pack_kv": L * n_segments(T, 256)}
    runs, toks = {}, {}
    for graph in (True, False):
        gen = Generator(eng, params, graph=graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _set_launches(dict.fromkeys(_counters(), 0))
        t = time.perf_counter()
        toks[graph] = np.stack(gen.generate(prompt, new))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        runs["graph" if graph else "eager"] = {
            "path": gen.last_path, "prefill_replays": gen.last_prefill_replays,
            "seconds": dt, "tok_s": toks[graph].size / dt,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "n_chunks_end": gen.last_cache["nc_host"],
            "launches": {k: v for k, v in _launches().items() if v}}
        del gen
        torch.cuda.empty_cache()
    agree = float((toks[True] == q8q4_toks[:, :new].numpy()).mean())
    equal = bool(np.array_equal(toks[True], toks[False]))
    emit("serve_swa_chunked", model=f"{m.name} x{L}L, window {m.sliding_window}, W8 "
                                    f"(random, seed 0)",
         batch=prompt.shape[0], prompt=T, new_tokens=new, segments=n_segments(T, 256),
         expected_launches=want, tokens_equal_eager=equal,
         token_agreement_with_serve_swa_q8q4=agree,
         first_token_equal_serve_swa_q8q4=bool((toks[True][:, 0]
                                                == q8q4_toks[:, 0].numpy()).all()),
         **runs)
    bad = [k for k, r in runs.items() if r["launches"] != want]
    if toks[True].shape != (prompt.shape[0], new) or bad or not equal \
            or runs["graph"]["prefill_replays"] != n_segments(T, 256) - 1:
        raise AssertionError(f"serve_swa_chunked: tokens {toks[True].shape}, equal to the "
                             f"eager run's {equal}; runs {bad} launched other than "
                             f"{want}: {runs}")


def serve_swa(entries, other, reference_runs, cb_runs):
    """Mistral-7B with its sliding window (``MISTRAL_7B_SWA``: 32 layers,
    hidden 4,096, 32 query and 8 kv heads, window 4,096) at full width and 8
    of its 32 layers (CUT_LAYERS; the run is host-bound), W8 random weights
    from seed 0 (the full model's first 8 layers), through the
    ``Generator``: B=4, a
    4,400-token prompt (past the window: banded prefill; 17 chunks packed)
    and 300 new tokens (from the first step the window leaves chunk 0 out;
    one compaction after step 240).  ``serve_swa_dense`` (plain route, no
    kernel), ``serve_swa_dense_kernel`` (kernel 4 with ``window``),
    ``serve_swa_q8q4`` (kernel 1; kernel 9 at prefill and the compaction),
    ``serve_swa_bitmap`` (kernel 6): each decode kernel 8 x 299 launches,
    every first token equal to ``serve_swa_dense``'s; tok/s, prefill
    seconds (a prefill of the prompt alone) and peak memory.  Then the same
    weights through the engine (``serve_cb_swa_q8q4``, ``serve_cb_swa_bitmap``:
    ``phase_serve_cb``'s requests, kernels 2 and 3, or 7 and 8, with the
    window) and the chunked Generator
    (``serve_swa_chunked``).  Fills the
    window's launches in the kernels line (q8, q4q4 and bitmap-q8 from
    ``reference_swa``'s and ``reference_swa_cb``'s runs on the card, tiny
    model)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, MISTRAL_7B_SWA as m
    from mustafar_tpu_torch.models.quant import init_params_w8, weight_bytes
    t = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    m, params = cut_depth(m, init_params_w8(m, g, device="cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompt = np.random.RandomState(0).randint(1, m.vocab_size, (SWA_B, SWA_PROMPT))
    steps = SWA_NEW - 1
    expected = m.num_layers * steps
    common = dict(model=m, max_seq_len=-(-SWA_PROMPT // 256) * 256 + SWA_NEW,
                  chunks_end=SWA_PROMPT // 256 + 1, time_prefill=True)
    model_note = (f"{m.name} x{m.num_layers}L, window {m.sliding_window}, W8 (random, "
                  f"seed 0)")
    dense_toks, launches, fields = serve("serve_swa_dense", CacheMode.DENSE, params, prompt,
                                         SWA_NEW, **common)
    emit("serve_swa_dense", model=model_note, weights_gib=weight_bytes(params) / 2 ** 30,
         weights_init_s=init_s, decode_steps=steps, **fields)
    if launches:
        raise AssertionError(f"serve_swa_dense launched {launches}")
    runs = (("serve_swa_dense_kernel", CacheMode.DENSE, "q8q4", True,
             {"flash_decode_attention": expected}, ("dense", "decode")),
            ("serve_swa_q8q4", CacheMode.COMPRESSED, "q8q4", False,
             {"fused_q_decode_attention": expected, "prune_quant_pack_kv": m.num_layers + 1},
             ("q8q4", "decode")),
            ("serve_swa_bitmap", CacheMode.COMPRESSED, "bitmap", False,
             {"fused_sparse_decode_attention": expected}, ("bitmap", "decode")))
    served = {}
    for label, mode, codec, use_pallas, want, key in runs:
        toks, launches, fields = serve(label, mode, params, prompt, SWA_NEW, codec=codec,
                                       use_pallas=use_pallas, **common)
        served[label] = toks
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, model=model_note, decode_steps=steps, expected_launches=want,
             first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(), **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal serve_swa_dense's: {first_equal}")
        name = _meta(codec if mode == CacheMode.COMPRESSED else "dense", "decode")[0]
        entries[key]["options"]["window"].update(
            launches=launches[name],
            launches_note=f"{label}: every decode launch with the window "
                          f"({m.sliding_window}), {m.num_layers} layers")
    for codec in ("q8", "q4q4", "bitmap-q8"):
        name = _meta(codec, "decode")[0]
        other[(codec, "decode")]["options"]["window"].update(
            launches=reference_runs[f"compressed/{codec}"]["launched"][name],
            launches_note="reference_swa's run on the card (tiny model, window 320)")
    for codec in ("q8q4", "bitmap"):
        launches, _ = phase_serve_cb(params, codec, model=m, eager_too=True)
        for kind in ("decode_ps", "segment"):
            entries[(codec, kind)]["options"]["window"].update(
                launches=launches[_meta(codec, kind)[0]],
                launches_note=f"serve_cb_swa_{codec}: every launch with the window "
                              f"({m.sliding_window}), {m.num_layers} layers")
    for codec in ("q8", "q4q4", "bitmap-q8"):
        for kind in ("decode_ps", "segment"):
            other[(codec, kind)]["options"]["window"].update(
                launches=cb_runs[f"engine/{codec}"]["launched"][_meta(codec, kind)[0]],
                launches_note="reference_swa_cb's engine on the card (tiny model, window "
                              "320)")
    phase_serve_swa_chunked(params, m, prompt, served["serve_swa_q8q4"])
    del params
    torch.cuda.empty_cache()


W8A8_NEW = 100   # new tokens of the W8A8 and Mixtral serve phases


def serve_w8a8(params, prompt, model=None):
    """Llama-3-8B in W8A8 at full width and ``model``'s depth (8 of the 32
    layers, CUT_LAYERS; host-bound) (the W8 weights of seed 0,
    ``enable_act_quant``: the int8 weights copied column-major, markers
    added) through the ``Generator``, B=8, prompt 300, W8A8_NEW new tokens:
    ``serve_w8a8_dense`` (no kernel) and ``serve_w8a8_q8q4`` (kernel 1 L x
    99, kernel 9 L for prefill's chunk), first tokens equal between the
    two; tok/s, prefill seconds, peak memory; and ``decode_split``'s parts
    for the W8A8 step (a layer's seven projections and the LM head through
    ``w8a8_dot``, device ms)."""
    import torch
    from mustafar_tpu_torch.config import CacheMode, LLAMA3_8B
    from mustafar_tpu_torch.models.quant import enable_act_quant, weight_bytes
    m = model or LLAMA3_8B
    t = time.perf_counter()
    a8 = enable_act_quant(params)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t
    steps = W8A8_NEW - 1
    dense_toks = None
    for label, mode, want in (("serve_w8a8_dense", CacheMode.DENSE, {}),
                              ("serve_w8a8_q8q4", CacheMode.COMPRESSED,
                               {"fused_q_decode_attention": m.num_layers * steps,
                                "prune_quant_pack_kv": m.num_layers})):
        toks, launches, fields = serve(label, mode, a8, prompt, W8A8_NEW, chunks_end=1,
                                       time_prefill=True, model=m)
        if dense_toks is None:
            dense_toks = toks
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        parts = {}
        if mode == CacheMode.COMPRESSED:
            layer_ms, layer_host_us, head_ms = _step_parts(a8)
            parts = {"w8a8_layer_ms": layer_ms, "w8a8_layer_host_us": layer_host_us,
                     "w8a8_lm_head_ms": head_ms}
        emit(label, model=f"{m.name} x{m.num_layers}L, W8A8 (random W8, seed 0; "
                          "enable_act_quant)",
             weights_gib=weight_bytes(a8) / 2 ** 30, act_quant_layout_s=layout_s,
             decode_steps=steps, expected_launches=want, first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(),
             **parts, **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal serve_w8a8_dense's: {first_equal}")
    del a8
    torch.cuda.empty_cache()


HARNESS_TASKS = ("passkey", "passage_retrieval_en", "trec")
HARNESS_MODEL = "Meta-Llama-3-8B"     # no chat template; MODEL2MAXLEN's default 4,096


def phase_harness_predict(params, model=None):
    """The LongBench harness at full width: Llama-3-8B at ``model``'s depth
    (8 of the 32 layers, CUT_LAYERS; host-bound), W8 (the
    run's params, seed 0), ``make_task_rows`` for HARNESS_TASKS, 2 rows
    each of about 3,000 bytes of context (trec's few-shot rows are shorter),
    through ``predict_dataset`` with ``ByteTokenizer`` (its ids, < 258, lie
    inside Llama-3's vocabulary) and model name HARNESS_MODEL, one row a
    ``Generator.generate`` (B=1), on the q8q4 cache at K=V 0.7 and on its
    dense twin; then ``evaluate_dir`` on the q8q4 predictions.  Kernel 1
    must launch once a layer a decode step summed over the rows, kernel 9 once
    a layer for every prefill that packs a chunk and once a compaction, no
    other kernel; every row's first token must equal the dense twin's; the
    result must score all three tasks.  Prints tok/s and the prefill
    seconds of the longest prompt."""
    import tempfile

    import numpy as np
    import torch
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.harness import configs
    from mustafar_tpu_torch.harness.longbench import (PredictConfig, evaluate_dir,
                                                      predict_dataset)
    from mustafar_tpu_torch.harness.longbench_synth import make_task_rows
    from mustafar_tpu_torch.harness.tinylm import EOS_ID, ByteTokenizer, load_corpus
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.runtime.generate import Generator

    class Counting(Generator):
        """The Generator with every call's prompt length, new-token budget
        and tokens kept (decode steps: min(len(out), budget - 1), EOS
        excluded from out)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.calls, self.compactions = [], 0
            compact = self.cache_impl.compact if hasattr(self.cache_impl, "compact") else None
            if compact is not None:
                def counted(state):
                    self.compactions += 1
                    return compact(state)
                self.cache_impl.compact = counted

        def generate(self, input_ids, max_new_tokens, eos_id=None, **kw):
            out = super().generate(input_ids, max_new_tokens, eos_id=eos_id, **kw)
            self.calls.append((np.asarray(input_ids).shape[1], max_new_tokens,
                               np.asarray(out[0])))
            return out

    m = model or LLAMA3_8B
    max_length = configs.model_max_len(HARNESS_MODEL)
    corpus = load_corpus(seed=1)
    rs = np.random.RandomState(0)
    rows = {t: make_task_rows(corpus, rs, t, 2, ctx_bytes=3000) for t in HARNESS_TASKS}
    tok = ByteTokenizer()
    prune = PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7, v_sparsity=0.7)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, mode in (("q8q4", CacheMode.COMPRESSED), ("dense", CacheMode.DENSE)):
            eng = EngineConfig(model=m, cache_mode=mode, prune=prune,
                               max_seq_len=max_length + 256, prefill_bucket=256,
                               chunk_size=256, codec="q8q4")
            gen = Counting(eng, params)
            gen.generate(np.asarray([tok.encode("warm-up " * 40)]), 2)     # not counted
            gen.calls, gen.compactions = [], 0
            pc = PredictConfig(model_name=HARNESS_MODEL, max_length=max_length,
                               out_dir=os.path.join(tmp, label))
            torch.cuda.synchronize()
            _set_launches(dict.fromkeys(_counters(), 0))
            t = time.perf_counter()
            for task in HARNESS_TASKS:
                predict_dataset(gen, tok, task, rows[task], pc, eos_id=EOS_ID,
                                progress=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            launches = {k: v for k, v in _launches().items() if v}
            runs[label] = dict(gen=gen, seconds=seconds, launches=launches,
                               out_dir=pc.out_dir)
        scores = evaluate_dir(runs["q8q4"]["out_dir"])
        q, d = runs["q8q4"]["gen"], runs["dense"]["gen"]
        steps = sum(min(len(out), budget - 1) for _, budget, out in q.calls)
        packing = sum(T - 32 >= 256 for T, _, _ in q.calls)
        want = {"fused_q_decode_attention": m.num_layers * steps,
                "prune_quant_pack_kv": m.num_layers * packing + q.compactions}
        first_equal = [int(a[2][0]) == int(b[2][0]) for a, b in zip(q.calls, d.calls)]
        generated = sum(len(out) for _, _, out in q.calls)
        # the prefill of the longest prompt alone, on the q8q4 engine
        T = max(c[0] for c in q.calls)
        toks = torch.zeros((1, q._bucket(T)), dtype=torch.int64, device="cuda")
        toks[0, :T] = torch.randint(0, 256, (T,), device="cuda")
        with torch.inference_mode():
            fresh = q.cache_impl.init(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            llama.prefill(m, params, toks, fresh, q.cache_impl, T, last_only=True)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
        del fresh
    emit("harness_predict", model=f"{m.name} x{m.num_layers}L, W8 (random, seed 0)",
         model_name=HARNESS_MODEL, max_length=max_length, tasks=list(HARNESS_TASKS),
         rows=len(q.calls), prompt_tokens=[c[0] for c in q.calls],
         max_new=[c[1] for c in q.calls], generated_tokens=generated, decode_steps=steps,
         packing_prefills=packing, compactions=q.compactions,
         seconds={k: r["seconds"] for k, r in runs.items()},
         tok_s={k: sum(len(c[2]) for c in r["gen"].calls) / r["seconds"]
                for k, r in runs.items()},
         prefill_s=prefill_s, prefill_tokens=T, launches=runs["q8q4"]["launches"],
         dense_launches=runs["dense"]["launches"], expected_launches=want,
         first_token_equal=sum(first_equal), scores=scores, nvidia_smi=nvidia_smi_line())
    if runs["q8q4"]["launches"] != want or runs["dense"]["launches"]:
        raise AssertionError(f"harness_predict: launched {runs['q8q4']['launches']} "
                             f"(expected {want}), dense {runs['dense']['launches']}")
    if not all(first_equal) or len(first_equal) != 2 * len(HARNESS_TASKS):
        raise AssertionError(f"harness_predict: first tokens differ from the dense twin's: "
                             f"{first_equal}")
    if sorted(scores) != sorted(HARNESS_TASKS):
        raise AssertionError(f"harness_predict: result.json holds {sorted(scores)}")
    del runs, q, d, gen
    torch.cuda.empty_cache()
    return want


ACCURACY_MODES = ("masked", "compressed", "compressed-q8q4", "compressed-q8q4+chunked",
                  "compressed-q8q4+w4")
# the least launches a layer of each kernel in harness_accuracy's grid: 768
# teacher-forced NLL steps a variant (nll_tokens 1024, prefill 256) on kernel
# 1 in the three q8q4 variants, on kernel 6 in the bitmap one, 7 W4
# projections a step in the W4 one; kernels 3 and 9 at least once (the
# passkey rows' decode steps and the packing counts hang on the data)
NLL_STEPS = 1024 - 256
ACCURACY_FLOOR = {"fused_q_decode_attention": 3 * NLL_STEPS,
                  "fused_sparse_decode_attention": NLL_STEPS,
                  "w4_matmul": 7 * NLL_STEPS,
                  "fused_q_segment_attention": 1, "prune_quant_pack_kv": 1}
# runs ``python -m mustafar_tpu_torch`` (runpy, as -m does) with the corpus
# roots chip_smoke chose, and writes the kernels' launch counts at its end
ACCURACY_LAUNCHER = """
import json, runpy, sys
roots, launches_file = json.loads(sys.argv[1]), sys.argv[2]
if roots is not None:
    from mustafar_tpu_torch.harness import tinylm
    tinylm._CORPUS_ROOTS = roots
sys.argv = ["mustafar_tpu_torch"] + sys.argv[3:]
runpy.run_module("mustafar_tpu_torch", run_name="__main__", alter_sys=True)
import chip_smoke
with open(launches_file, "w") as f:
    json.dump({k: v for k, v in chip_smoke._launches().items() if v}, f)
"""


def _recorded_grids():
    """The JAX package's recorded grids on ckpt/tiny-acc (40 rows), by
    variant name: ``accuracy/`` and, for the W4 rows, ``accuracy_w4/``."""
    rec = {}
    for d in ("accuracy_w4", "accuracy"):
        path = os.path.join(ROOT, d, "result.json")
        if os.path.exists(path):
            with open(path) as f:
                rec.update({k: dict(v, source=f"{d}/result.json")
                            for k, v in json.load(f).items()})
    return rec


def phase_harness_accuracy():
    """The accuracy grid through the entry point on the trained weights:
    ``python -m mustafar_tpu_torch accuracy --ckpt ckpt/tiny-acc --rows 16
    --ctx 1600 --sparsities 0.7 --modes`` ACCURACY_MODES in a subprocess on
    the card (dense, masked, bitmap, q8q4, q8q4 with chunked prefill and with
    W4 weights: kernels 1, 3, 5, 6, 9), then ``python -m mustafar_tpu_torch
    eval`` on the dense variant's directory.  Each variant's passkey
    accuracy, NLL and KL against dense beside the JAX package's recorded row
    of the same name (another machine's corpus: numbers, not tokens); dense
    passkey accuracy must reach 90 %.  The subprocess runs on the card (its
    environment without MUSTAFAR_CPU) and must launch each of the grid's
    kernels, the decode kernels at least once a layer for each of the
    teacher-forced NLL steps of their variants (ACCURACY_FLOOR)."""
    import tempfile
    from mustafar_tpu_torch.harness import tinylm
    roots = tinylm._CORPUS_ROOTS
    env = {k: v for k, v in os.environ.items() if k != "MUSTAFAR_CPU"}
    with tempfile.TemporaryDirectory() as tmp:
        out, launches_file = os.path.join(tmp, "grid"), os.path.join(tmp, "launches.json")
        cmd = [sys.executable, "-c", ACCURACY_LAUNCHER, json.dumps(roots), launches_file,
               "accuracy", "--ckpt", os.path.join("ckpt", "tiny-acc"), "--out", out,
               "--rows", "16", "--ctx", "1600", "--sparsities", "0.7",
               "--modes", *ACCURACY_MODES]
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"harness_accuracy: the accuracy subcommand failed "
                                 f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        with open(os.path.join(out, "result.json")) as f:
            grid = json.load(f)
        with open(launches_file) as f:
            launches = json.load(f)
        ev = subprocess.run([sys.executable, "-m", "mustafar_tpu_torch", "eval",
                             "--pred_dir", os.path.join(out, "dense")], cwd=ROOT,
                            env=env, capture_output=True, text=True, timeout=300)
        if ev.returncode != 0:
            raise AssertionError(f"harness_accuracy: eval failed:\n{ev.stderr[-4000:]}")
        evaluated = json.loads(ev.stdout)
    recorded = _recorded_grids()
    keys = ("passkey_acc", "nll", "kl_vs_dense")
    table = {name: {"card": {k: row.get(k) for k in keys},
                    "recorded": ({k: recorded[name].get(k) for k in keys + ("source",)}
                                 if name in recorded else None)}
             for name, row in grid.items()}
    with open(os.path.join(ROOT, "ckpt", "tiny-acc", "config.json")) as f:
        layers = json.load(f)["num_layers"]
    floor = {k: layers * v for k, v in ACCURACY_FLOOR.items()}
    emit("harness_accuracy", ckpt="ckpt/tiny-acc", rows=16, ctx_bytes=1600,
         sparsity=0.7, modes=list(ACCURACY_MODES), seconds=seconds, corpus_roots=roots,
         grid=table, eval_dense=evaluated, launches=launches, launch_floor=floor,
         nvidia_smi=nvidia_smi_line())
    short = {k: launches.get(k, 0) for k, v in floor.items() if launches.get(k, 0) < v}
    if short:
        raise AssertionError(f"harness_accuracy: kernels launched below their floor "
                             f"{floor}: {short}")
    want = ["dense"] + [f"{mm.replace('+w4', '')}@0.7" + ("+w4" if "+w4" in mm else "")
                        for mm in ACCURACY_MODES]
    if sorted(grid) != sorted(want):
        raise AssertionError(f"harness_accuracy: variants {sorted(grid)}, expected {want}")
    if grid["dense"]["passkey_acc"] < 90 or evaluated.get("passkey") != grid["dense"][
            "passkey_acc"]:
        raise AssertionError(f"harness_accuracy: dense passkey accuracy "
                             f"{grid['dense']['passkey_acc']} (eval {evaluated}); "
                             f"at least 90 expected")
    return launches


# absolute, NLL and KL card against CPU: a tenth of the pruned variants' KL
# against dense (~1e-2), 25x the widest spread of the sound runs (KL 4e-5)
HARNESS_TOL = 1e-3


def _tie_margin(gen, prompt_ids, ref_pred, other_pred):
    """Where two passkey predictions part: ``gen``'s margin between its own
    pick and ``other_pred``'s byte, fed ``ref_pred``'s bytes up to there
    (EOS where ``ref_pred`` ends first).  0 where they agree."""
    import torch
    from mustafar_tpu_torch.harness.tinylm import EOS_ID
    from mustafar_tpu_torch.models import llama
    a, b = list(ref_pred.encode("utf-8")), list(other_pred.encode("utf-8"))
    k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    if a == b:
        return 0.0
    other = b[k] if k < len(b) else EOS_ID
    impl, T = gen.cache_impl, prompt_ids.shape[1]
    toks = torch.zeros((1, gen._bucket(T)), dtype=torch.int64, device=gen.device)
    toks[0, :T] = torch.as_tensor(prompt_ids[0])
    with torch.inference_mode():
        cache = impl.init(1, gen.dtype)
        logits, cache = llama.prefill(gen.cfg, gen.params, toks, cache, impl, T,
                                      last_only=True)
        for i, t in enumerate(a[:k]):
            logits, cache = llama.decode_step(
                gen.cfg, gen.params, torch.tensor([[t]], device=gen.device), cache, impl,
                T + i)
            if hasattr(impl, "compact") and impl.window_full(cache, T + i + 1):
                impl.compact(cache)
    row = logits[0, 0].float()
    return float(row.max() - row[other])


def phase_reference_harness():
    """``run_accuracy`` in process twice with the same arguments, on the card
    and on the CPU: ckpt/tiny-acc, 4 rows of 1,600 bytes, ``nll_tokens``
    384, modes ``compressed`` and ``compressed-q8q4`` at 0.7.  Passkey
    accuracy equal, NLL and KL against dense within HARNESS_TOL, every
    row's prediction equal or parted at a near-tie (the CPU's margin
    between its byte and the card's within SWA_TIE_TOL)."""
    import tempfile

    import numpy as np
    import torch
    from mustafar_tpu_torch.harness import tinylm
    from mustafar_tpu_torch.harness.configs import DATASET2PROMPT
    from mustafar_tpu_torch.harness.longbench import truncate_middle
    from mustafar_tpu_torch.runtime.generate import Generator
    from mustafar_tpu_torch.weights import load_ckpt
    kw = dict(n_rows=4, ctx_bytes=1600, sparsities=(0.7,),
              modes=("compressed", "compressed-q8q4"), nll_tokens=384,
              log=lambda *a: None)
    ckpt = os.path.join(ROOT, "ckpt", "tiny-acc")
    launches0 = _launches()
    grids, preds, seconds = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            grids[dev] = tinylm.run_accuracy(ckpt, os.path.join(tmp, dev), device=dev, **kw)
            seconds[dev] = time.perf_counter() - t
            for name in grids[dev]:
                with open(os.path.join(tmp, dev, name, "passkey.jsonl")) as f:
                    preds[dev, name] = [json.loads(line)["pred"] for line in f]
    launched = {k: v - launches0[k] for k, v in _launches().items() if v > launches0[k]}
    _set_launches(launches0)
    # the rows run_accuracy made (its corpus and generator seeds)
    corpus = tinylm.load_corpus(seed=1235)
    rng = np.random.RandomState(1234)
    rows = [tinylm.make_passkey_row(corpus, rng, 1600) for _ in range(4)]
    max_seq = ((1600 + len(tinylm.PASSKEY_QUESTION) + 256) // 256 + 1) * 256 + 256
    tok = tinylm.ByteTokenizer()
    _, cpu_params = load_ckpt(ckpt, device="cpu")
    flips, bad = [], []
    for name, row in grids["cpu"].items():
        card = grids["cuda"][name]
        if card["passkey_acc"] != row["passkey_acc"]:
            bad.append((name, "passkey_acc", card["passkey_acc"], row["passkey_acc"]))
        for k in ("nll", "kl_vs_dense"):
            if k in row and abs(card[k] - row[k]) > HARNESS_TOL:
                bad.append((name, k, card[k], row[k]))
        mode = "dense" if name == "dense" else name.split("@")[0]
        gen = None
        for i, (a, b) in enumerate(zip(preds["cpu", name], preds["cuda", name])):
            if a == b:
                continue
            if gen is None:
                gen = Generator(tinylm._engine(tinylm.TINY_ACC, mode, 0.7, max_seq),
                                cpu_params, dtype=torch.float32, device="cpu")
            prompt = truncate_middle(tok, DATASET2PROMPT["passkey"].format(
                context=rows[i]["context"], input=""), max_seq - 64)
            margin = _tie_margin(gen, tok(prompt, return_tensors="np").input_ids, a, b)
            flips.append({"variant": name, "row": i, "cpu": a, "card": b,
                          "cpu_margin": margin})
    wide = [f for f in flips if f["cpu_margin"] > SWA_TIE_TOL]
    emit("reference_harness", ckpt="ckpt/tiny-acc", rows=4, nll_tokens=384,
         grids=grids, seconds=seconds, flips=flips, launched=launched, tol=HARNESS_TOL,
         picks_note=SWA_PICKS_NOTE)
    if bad or wide:
        raise AssertionError(f"reference_harness: card and CPU disagree: {bad}, "
                             f"flips beyond SWA_TIE_TOL {wide}")
    return launched


def _moe_parts(params, m):
    """At B=8, one decode step's parts on Mixtral: a layer's MoE MLP
    (router, dispatch, the three expert products over all E experts,
    combine), device ms averaged over every fourth layer, beside its bound
    (the experts' int8 weights and scales and the router, read once, over
    the card's memory rate) and its host us; a layer's four attention
    projections (W8), device ms."""
    import torch
    from mustafar_tpu_torch.models.moe import moe_mlp
    from mustafar_tpu_torch.models.quant import proj
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    h = torch.randn((8, 1, m.hidden_size), generator=g, device="cuda").to(torch.bfloat16)
    hq = torch.randn((8, 1, m.q_dim), generator=g, device="cuda").to(torch.bfloat16)
    layers = params["layers"]

    def lp(li):
        return {name: leaf[li] for name, leaf in layers.items()}

    def attn(li):
        p = lp(li)
        for name in ("wq", "wk", "wv"):
            proj(h, p, name)
        proj(hq, p, "wo")

    sampled = range(0, m.num_layers, 4)
    with torch.inference_mode():
        moe_mlp(m, lp(0), h)
        attn(0)
        torch.cuda.synchronize()
        moe = [cuda_ms(lambda li=li: moe_mlp(m, lp(li), h), 3, spin_cycles=4 * SPIN_CYCLES)
               for li in sampled]
        attn_ms = sum(cuda_ms(lambda li=li: attn(li), 3)[0] for li in sampled) / len(sampled)
        host = host_us(lambda: moe_mlp(m, lp(0), h), 5)
    nbytes = sum(layers[k][0].numel() * layers[k].element_size()
                 for k in layers if k.startswith("we_") or k == "w_router")
    moe_ms = sum(t for t, _ in moe) / len(moe)
    return {"moe_mlp_ms": moe_ms, "moe_mlp_bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
            "moe_mlp_bound_by": "bytes", "moe_mlp_bytes": nbytes,
            "moe_mlp_share_of_bound": nbytes / H100_BYTES_PER_S * 1e3 / moe_ms,
            "moe_mlp_host_us": host, "moe_mlp_waited_on_host": sum(b for _, b in moe),
            "attention_projections_ms": attn_ms}


def serve_moe():
    """Mixtral-8x7B (``MIXTRAL_8X7B``: Mistral-7B's attention, 8 experts of
    14,336, top-2) at full width, W8 random weights from seed 0 for its 32
    layers (``init_params_w8``: the experts drawn one (layer, expert) at a
    time into int8), made after every other model is freed.  The
    ``Generator`` at 8 of the 32 layers (CUT_LAYERS;
    host-bound), B=8, prompt 300, W8A8_NEW new tokens: ``serve_moe_dense``
    (no kernel), ``serve_moe_q8q4`` (kernel 1 8 x 99, kernel 9 8),
    ``serve_moe_bitmap`` (kernel 6 8 x 99), first tokens equal to the dense
    run's; tok/s,
    prefill seconds, peak memory, weights GiB, and one decode step's MoE
    MLP and attention projections (``_moe_parts``).  Then the engine on
    ``phase_serve_cb``'s 17 requests at q8q4 (``serve_cb_moe``), at the same
    8 layers."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, MIXTRAL_8X7B as m
    from mustafar_tpu_torch.models.quant import init_params_w8, weight_bytes
    t = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = init_params_w8(m, g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    parts = _moe_parts(params, m)
    weights_gib = weight_bytes(params) / 2 ** 30
    m, params = cut_depth(m, params)
    L, steps = m.num_layers, W8A8_NEW - 1
    prompt = np.random.RandomState(0).randint(1, m.vocab_size, (8, 300))
    note = (f"{m.name} x{L}L (CUT_LAYERS), {m.num_experts} experts "
            f"top-{m.num_experts_per_tok}, W8 (random, seed 0; 32 layers made)")
    dense_toks = None
    for label, mode, codec, want in (
            ("serve_moe_dense", CacheMode.DENSE, "q8q4", {}),
            ("serve_moe_q8q4", CacheMode.COMPRESSED, "q8q4",
             {"fused_q_decode_attention": L * steps, "prune_quant_pack_kv": L}),
            ("serve_moe_bitmap", CacheMode.COMPRESSED, "bitmap",
             {"fused_sparse_decode_attention": L * steps})):
        toks, launches, fields = serve(label, mode, params, prompt, W8A8_NEW, codec=codec,
                                       model=m, chunks_end=1, time_prefill=True)
        if dense_toks is None:
            dense_toks = toks
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, model=note, weights_gib=weights_gib,
             weights_init_s=init_s, decode_steps=steps, expected_launches=want,
             first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(),
             **(parts if mode == CacheMode.DENSE else {}), **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal serve_moe_dense's: {first_equal}")
    phase_serve_cb(params, "q8q4", model=m, eager_too=True)
    del params
    torch.cuda.empty_cache()


# -- parallelism: ranks as processes on this card over gloo ---------------------

SHARDED_REQS = ((120, 10), (280, 30), (530, 25), (64, 12), (300, 20))
SHARDED_CODECS = (("COMPRESSED", "q8q4"), ("MASKED", "bitmap"), ("COMPRESSED", "bitmap-q8"))
RANK_TIMEOUT_S = 300
# the bf16 bound of a tensor-parallel run's logits against one rank's: the
# row-parallel sums round once more (in f32, then to bf16) and the order
# differs, a few bf16 ulps of the activations a layer; the CPU tests' bound
# for a bf16 model against another framework's (tests/test_torch_model.py)
TP_BF16_TOL = 6e-2


def _spawned(target, dp, tp, kwargs, **kw):
    """``parallel.distributed.spawn`` of a rank body (``distributed``'s by
    its name, another module's as ``module:function``; every rank on this
    card over gloo unless ``backend`` and ``device`` say otherwise), and
    the wall seconds it took (the processes' start included)."""
    from mustafar_tpu_torch.parallel import distributed as dr
    t = time.perf_counter()
    if ":" not in target:
        target = "mustafar_tpu_torch.parallel.distributed:" + target
    out = dr.spawn(target, dp, tp, kwargs,
                   backend=kw.pop("backend", "gloo"), device=kw.pop("device", "cuda"),
                   timeout_s=RANK_TIMEOUT_S, **kw)
    return out, time.perf_counter() - t


def _rank_gate(label, res, L, codec, packs=False):
    """A rank's launches as serve_cb gates them: the codec's per-slot
    kernel L x its decode steps, its segment kernel L x its segments, and
    with ``packs`` kernel 9 L x its segments (each stages its layer's pack)
    plus its compactions; no other kernel."""
    if codec is None:
        want = {}
    else:
        want = {_meta(codec, "decode_ps")[0]: L * res["decode_steps"]}
        if res["segments"]:
            want[_meta(codec, "segment")[0]] = L * res["segments"]
        if packs:
            want["prune_quant_pack_kv"] = L * res["segments"] + res["compactions"]
    got = {k: v for k, v in res["launches"].items() if v}
    if not packs:
        got.pop("prune_quant_pack_kv", None)
    if got != want:
        raise AssertionError(f"{label}: a rank launched {got}, expected {want}")
    return got


def phase_reference_sharded():
    """The trained ckpt/tiny-acc (f32, Hkv 2) through the continuous-batching
    engine at dp=2 x tp=2: four processes on this card over gloo (the
    ``parallel.distributed.engine_cases`` rank body, one spawn), the
    requests of tests/test_torch_scheduler_sharded.py (``RandomState(3)``)
    on the q8q4 compressed, masked and bitmap-q8 compressed caches: every
    rank's tokens equal the single-rank card run's and the CPU run's; each
    rank launches the per-slot kernel 4 times (the layers) a decode step of
    its own (none on the masked cache) and the two data groups' kernel 9 launches sum to the
    single rank's.  Then Mixtral's MLP (reference_moe's tiny MoE with 2 kv
    heads, W8 experts' f32 originals, 4 experts over 2 ranks) at dp=1 x
    tp=2 through the q8q4 engine, experts and heads over "model", and at
    dp=2 x tp=2 in the four ranks' spawn with 32 slots and 20 requests (a
    decode step's 32 rows overflow an expert's 16 slots: every data group
    routes the whole batch): tokens equal one rank's on the card and the
    CPU's."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from mustafar_tpu_torch import config as tc
    from mustafar_tpu_torch.parallel import distributed as dr
    counts0 = _launches()
    params = dr.load_params_npz(os.path.join(ROOT, "ckpt", "tiny-acc", "params.npz"))
    with open(os.path.join(ROOT, "ckpt", "tiny-acc", "config.json")) as f:
        model = tc.ModelConfig(**json.load(f))

    def engine(mode, codec, m=model):
        return tc.EngineConfig(model=m, cache_mode=getattr(tc.CacheMode, mode),
                               prune=tc.PruneConfig(method=tc.PruneMethod.KT_MAG_VT_MAG,
                                                    k_sparsity=0.5, v_sparsity=0.5),
                               max_seq_len=1024, prefill_bucket=256, chunk_size=256,
                               codec=codec, batch_size=4)

    rs = np.random.RandomState(3)
    reqs = [(rs.randint(0, 256, size=n), m) for n, m in SHARDED_REQS]
    cases = [dict(engine=engine(mode, codec), params=params, requests=reqs, device="cuda")
             for mode, codec in SHARDED_CODECS]
    moe = dataclasses.replace(_tiny_engine(tc.CacheMode.COMPRESSED, moe=True).model,
                              num_kv_heads=2)
    rs = np.random.RandomState(4)
    moe_case = dict(engine=engine("COMPRESSED", "q8q4", moe),
                    params=dr.init_params_np(moe, 4),
                    requests=[(rs.randint(0, 512, size=n), m)
                              for n, m in ((300, 12), (90, 16), (530, 8))], device="cuda")
    rs = np.random.RandomState(8)
    moe_dp_case = dict(moe_case, engine=dataclasses.replace(moe_case["engine"],
                                                            batch_size=32),
                       requests=[(rs.randint(0, 512, size=30 + 11 * i), 6 + i % 3)
                                 for i in range(20)])
    # the six ranks run while this process runs one rank on the card and the CPU
    with ThreadPoolExecutor(2) as ex:
        spawns = (ex.submit(_spawned, "engine_cases", 2, 2,
                            {"cases": cases + [moe_dp_case]}),
                  ex.submit(_spawned, "engine_case", 1, 2, moe_case))
        singles = [(dr.engine_case(None, **case),
                    dr.engine_case(None, **dict(case, device="cpu")))
                   for case in cases + [moe_dp_case, moe_case]]
        (sharded, sharded_s), (moe_ranks, moe_s) = (f.result() for f in spawns)
    fields, bad = {}, []
    labels = SHARDED_CODECS + (("MOE_DP2", "q8q4"), ("MOE", "q8q4"))
    for i, ((mode, codec), case) in enumerate(zip(labels,
                                                  cases + [moe_dp_case, moe_case])):
        ranks = [r[i] for r in sharded] if i <= len(cases) else moe_ranks
        tp = 2
        card, cpu = singles[i]
        L = case["engine"].model.num_layers
        kcodec = codec if mode != "MASKED" else None
        gates = [_rank_gate(f"reference_sharded {mode} {codec}", r, L, kcodec)
                 for r in ranks]
        packs = [r["launches"]["prune_quant_pack_kv"] for r in ranks]
        if codec in QUANT_BITS and sum(packs[::tp]) != card["launches"]["prune_quant_pack_kv"]:
            bad.append(f"{mode} {codec}: the data groups packed {packs}, one rank "
                       f"{card['launches']['prune_quant_pack_kv']}")
        equal = [r["outs"] == card["outs"] for r in ranks]
        if not (all(equal) and card["outs"] == cpu["outs"]):
            bad.append(f"{mode} {codec}: ranks equal to one card rank {equal}, card equal "
                       f"to CPU {card['outs'] == cpu['outs']}")
        fields[f"{mode.lower()}_{codec}"] = {
            "ranks": len(ranks), "tokens": sum(len(t) for t in card["outs"].values()),
            "rank_decode_steps": [r["decode_steps"] for r in ranks],
            "one_rank_decode_steps": card["decode_steps"], "rank_launches": gates,
            "rank_packs": packs, "equal_to_one_rank": equal,
            "card_equal_cpu": card["outs"] == cpu["outs"]}
    import torch
    nccl = ("not run: dp=2 x tp=2 over nccl needs four cards, this host has "
            f"{torch.cuda.device_count()}")
    if torch.cuda.device_count() >= 4:
        nranks, nccl_s = _spawned("engine_cases", 2, 2, {"cases": cases},
                                  backend="nccl", device="cuda:{rank}")
        nccl = {"seconds": nccl_s, "equal_to_one_rank": [
            [r[i]["outs"] == singles[i][0]["outs"] for r in nranks]
            for i in range(len(cases))]}
        if not all(all(e) for e in nccl["equal_to_one_rank"]):
            bad.append(f"over nccl: {nccl}")
    _set_launches(counts0)
    emit("reference_sharded", mesh="dp=2 x tp=2 (MoE also dp=1 x tp=2)", backend="gloo",
         processes_on_one_card=4, spawn_s=sharded_s, moe_spawn_s=moe_s, nccl=nccl,
         **fields)
    if bad:
        raise AssertionError(f"reference_sharded: {bad}")
    return fields


def _tick_split(res):
    """A rank's ticks from ``engine_case(..., time_collectives=True)``: the
    untimed ticks' mean wall ms, the timed ticks' mean wall ms, their
    collectives' mean ms and count a tick, and that ms over the untimed
    tick's."""
    import numpy as np
    ticks = np.asarray(res["tick_s"])
    timed = np.asarray(res["timed"], bool)
    coll = np.asarray(res["collective_s"])
    untimed_ms = 1e3 * float(ticks[~timed].mean())
    coll_ms = 1e3 * float(coll.mean())
    return {"ticks": len(ticks), "timed_ticks": int(timed.sum()),
            "tick_ms_untimed_mean": untimed_ms,
            "tick_ms_timed_mean": 1e3 * float(ticks[timed].mean()),
            "collective_ms_per_tick": coll_ms,
            "collectives_per_tick": float(np.mean(res["collective_n"])),
            "collective_share_of_untimed_tick": coll_ms / untimed_ms}


def phase_serve_cb_tp(model):
    """Llama-3-8B at full width (32 heads, 8 kv heads, hidden 4,096) and
    ``model``'s depth (CUT_LAYERS), W8 random weights (init_params_w8, seed
    0), q8q4 at 0.7, chunked interleaved admission, serve_cb's first 8
    requests, through the engine at tp=2: two processes on this card over
    gloo, each making the weights and cutting its shard (heads, kv heads
    and the MLP over "model"; the LM head over the vocabulary).  First
    tokens equal the single-rank engine's; the first decode step's logits
    within TP_BF16_TOL of their range; each rank's launches gated as
    serve_cb's (kernel 2 L x decode steps, kernel 3 L x segments, kernel 9
    L x prompt chunks + compactions).  Every other tick's all-reduces are
    timed, each bracketed by synchronizes (``engine_case``'s
    ``time_collectives``): the untimed ticks give the wall ms of a tick,
    the timed ones its collectives' ms (and their own wall ms, which shows
    what the brackets cost).  On a host with two cards or more, the same run over nccl, one
    card a rank; otherwise a line says nccl across cards was not run."""
    import functools
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, PruneConfig,
                                           PruneMethod)
    from mustafar_tpu_torch.models.quant import init_params_w8
    from mustafar_tpu_torch.parallel import distributed as dr
    counts0 = _launches()
    eng = EngineConfig(model=model, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                                         v_sparsity=0.7),
                       max_seq_len=8448, prefill_bucket=256, chunk_size=256, codec="q8q4",
                       batch_size=8, chunked_prefill=True)
    reqs = serve_cb_requests(model, first8=True)
    case = dict(engine=eng, params=functools.partial(init_params_w8, model, None, None, 0),
                requests=reqs, dtype=torch.bfloat16, device="cuda", record_steps=1)
    t = time.perf_counter()
    one = dr.engine_case(None, **case)
    one_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    ranks, tp_s = _spawned("engine_case", 1, 2, dict(case, time_collectives=True))
    L = model.num_layers
    gates = [_rank_gate("serve_cb_tp", r, L, "q8q4", packs=True) for r in ranks]
    first = [[r["outs"][u][0] for u in sorted(r["outs"])] for r in ranks]
    want_first = [one["outs"][u][0] for u in sorted(one["outs"])]
    ref = one["logits"][0]
    scale = float(np.abs(ref).max())
    errs = [float(np.abs(r["logits"][0] - ref).max()) for r in ranks]
    agreement = [float(np.mean([a == b for u in one["outs"]
                                for a, b in zip(r["outs"][u], one["outs"][u])]))
                 for r in ranks]
    per_rank = [dict(_tick_split(r), decode_steps=r["decode_steps"],
                     segments=r["segments"], compactions=r["compactions"])
                for r in ranks]
    nccl = "not run: nccl across cards needs two cards, this host has " \
        f"{torch.cuda.device_count()}"
    if torch.cuda.device_count() >= 2:
        nranks, nccl_s = _spawned("engine_case", 1, 2, dict(case, time_collectives=True),
                                  backend="nccl", device="cuda:{rank}")
        nccl = {"seconds": nccl_s, "first_equal": [
            [r["outs"][u][0] for u in sorted(r["outs"])] == want_first for r in nranks],
            "tokens_equal_gloo": [r["outs"] == ranks[0]["outs"] for r in nranks],
            "per_rank": [_tick_split(r) for r in nranks]}
    _set_launches(counts0)
    emit("serve_cb_tp", model=f"{model.name} x{L}L (CUT_LAYERS), W8 (random, seed 0)",
         mesh="dp=1 x tp=2", backend="gloo", processes_on_one_card=2, codec="q8q4",
         requests=len(reqs), one_rank_s=one_s, tp_s=tp_s,
         one_rank_tick_ms_mean=1e3 * sum(one["tick_s"]) / len(one["tick_s"]),
         timing="untimed ticks: wall time; every other tick: all-reduces "
                "synchronize-bracketed",
         first_token_equal=[f == want_first for f in first],
         first_step_logits_max_abs_err=errs, logits_scale=scale,
         tol=TP_BF16_TOL * scale, token_agreement_with_one_rank=agreement,
         rank_launches=gates, per_rank=per_rank, nccl=nccl)
    if not all(f == want_first for f in first) or max(errs) > TP_BF16_TOL * scale:
        raise AssertionError(f"serve_cb_tp: first tokens {first} against {want_first}, "
                             f"first step's logits {errs} against {TP_BF16_TOL * scale}")
    if isinstance(nccl, dict) and not all(nccl["first_equal"]):
        raise AssertionError(f"serve_cb_tp over nccl: {nccl}")
    return gates


def phase_dist_recovery():
    """``python -m mustafar_tpu_torch.parallel.distributed`` on this card:
    two processes over gloo (tp=2) run the q8q4 step program's timed decode
    (16 steps; kernel 1 2 x 16, kernel 9 2 a rank) and, beside them, two
    more the failure drill with a snapshot each step: process 1 exits at
    step 4 and the survivor must report ``peer_loss_detected`` within its
    3 s barrier deadline (plus 5 s); its snapshot (4 steps) recovers at
    tp=1 in this process
    (``run_recovery``: prefill, checked replay, the rest) to the timed run's
    stream, token for token."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from mustafar_tpu_torch.parallel import distributed as dr
    counts0 = _launches()
    tmp = tempfile.mkdtemp(prefix="dist_recovery_")
    steps, die_at, barrier_ms = 16, 4, 3000

    def launch(tag, extra):
        t = time.perf_counter()
        outs = [os.path.join(tmp, f"{tag}{i}.json") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mustafar_tpu_torch.parallel.distributed",
             "--coordinator", f"file://{tmp}/{tag}.store", "--num-processes", "2",
             "--process-id", str(i), "--backend", "gloo", "--device", "cuda",
             "--tp", "2", "--program", "q8q4", "--steps", str(steps),
             "--timeout-s", "120", "--out", outs[i], *extra],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(2)]
        logs = []
        try:
            logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0].decode()[-2000:]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        res = [json.load(open(o)) if os.path.exists(o) else None for o in outs]
        return res, [p.returncode for p in procs], logs, time.perf_counter() - t

    snap = os.path.join(tmp, "snap.json")
    # the two runs side by side: four processes on the card
    with ThreadPoolExecutor(2) as ex:
        runs = (ex.submit(launch, "timed", []),
                ex.submit(launch, "died", ["--die-after", str(die_at), "--barrier-ms",
                                           str(barrier_ms), "--snapshot", snap]))
        (timed, codes, logs, timed_s), (died, dcodes, dlogs, died_s) = (
            f.result() for f in runs)
    if codes != [0, 0]:
        raise AssertionError(f"dist_recovery: the timed run exited {codes}: {logs}")
    want = {"fused_q_decode_attention": 2 * steps, "prune_quant_pack_kv": 2}
    got = [{k: v for k, v in r["launches"].items() if v} for r in timed]
    survivor = died[0] or {}
    t = time.perf_counter()
    rec = dr.run_recovery(snap, None, device="cuda")
    rec_s = time.perf_counter() - t
    ref = timed[0]["stream"]
    _set_launches(counts0)
    emit("dist_recovery", backend="gloo", processes_on_one_card=2, program="q8q4",
         steps=steps, timed_s=timed_s, step_ms=[r["step_ms"] for r in timed],
         rank_launches=got, died_exit_codes=dcodes, died_s=died_s,
         peer_loss_detected=survivor.get("peer_loss_detected"),
         error_type=survivor.get("error_type"), error=survivor.get("error"),
         detected_after_s=survivor.get("detected_after_s"), barrier_ms=barrier_ms,
         recovered_from_step=rec["recovered_from_step"], recovery_tp=rec["tp"],
         recovery_s=rec_s, replay_s=rec["replay_s"],
         token_exact=rec["stream"] == ref, ranks_agree=timed[1]["stream"] == ref)
    if got != [want, want] or timed[1]["stream"] != ref:
        raise AssertionError(f"dist_recovery: launches {got} (expected {want}), streams "
                             f"equal {timed[1]['stream'] == ref}")
    if dcodes != [0, 17] or not survivor.get("peer_loss_detected") or \
            survivor["detected_after_s"] > barrier_ms / 1e3 + 5:
        raise AssertionError(f"dist_recovery: the drill exited {dcodes}, survivor "
                             f"{survivor}: {dlogs}")
    if rec["stream"] != ref or rec["recovered_from_step"] != die_at:
        raise AssertionError(f"dist_recovery: recovery from step "
                             f"{rec['recovered_from_step']} is not token-exact")


# -- sequence-parallel prefill, the pipeline, training -------------------------

RING = "mustafar_tpu_torch.parallel.ring:"
PIPE = "mustafar_tpu_torch.parallel.pipeline:"
SP_TOL = 5e-4            # the CPU tests' bound for SP and PP runs (tests/test_torch_ring.py)
# of the logits' range: card against CPU (the CPU tests' tie tolerance for a
# kernel's route), and ranks that cut the heads against one rank: there
# kernel 4 reads q in bf16 after the row-parallel sums ran in another order,
# so last-bit differences flip bf16 roundings (2.2e-4 to 8.6e-4 of a ~1.5
# range on the tiny model, NVIDIA H100 80GB HBM3)
RANGE_TOL = 1e-2
TRAIN_TOL = 1e-4         # relative: step 1's loss and gradient norm, card against CPU
# every method family of the SP prefill prune: per token, ThinK, channels by
# magnitude and by Opa scores, Opa keys; the dense cache
RING_METHODS = (("DENSE", "KT_MAG_VT_MAG"), ("MASKED", "KT_MAG_VT_MAG"), ("MASKED", "THINK"),
                ("MASKED", "KT_MAG_VC_MAG"), ("MASKED", "KT_MAG_VC_OPA"),
                ("MASKED", "KT_OPA_VT_MAG"))


def _tiny_parallel_engine(mode, method, sparsity=0.5):
    """reference_sharded's tiny model (head_dim 128, 4 heads, hidden 256)
    with 2 kv heads, so tp=2 cuts them."""
    import dataclasses
    from mustafar_tpu_torch import config as tc
    model = dataclasses.replace(_tiny_engine(tc.CacheMode.MASKED).model, num_kv_heads=2)
    sp = 0.0 if mode == "DENSE" else sparsity
    return tc.EngineConfig(model=model, cache_mode=getattr(tc.CacheMode, mode),
                           prune=tc.PruneConfig(method=getattr(tc.PruneMethod, method),
                                                k_sparsity=sp, v_sparsity=sp),
                           max_seq_len=1024)


def _steps(out):
    import numpy as np
    return np.stack([out["prefill"]] + out["decode"])


def _hold_ranks(label, ranks, card, cpu, want_launches, bad, card_launches=None,
                cut_heads=False):
    """Every rank's greedy picks equal to one card rank's and its logits
    (prefill and each step) within SP_TOL of them (RANGE_TOL of their range
    where the ranks cut the heads, ``cut_heads``), the card's within
    RANGE_TOL of the logits' range of the CPU's, every rank's launches
    ``want_launches`` and the card rank's ``card_launches`` (default the
    same); returns the errors."""
    import numpy as np
    ref = _steps(card)
    errs = [float(np.abs(_steps(r) - ref).max()) for r in ranks]
    scale = float(np.abs(_steps(cpu)).max())
    cpu_err = float(np.abs(ref - _steps(cpu)).max())
    launches = [r["launches"] for r in ranks]
    tol = RANGE_TOL * scale if cut_heads else SP_TOL
    picks = [bool((np.argmax(_steps(r), -1) == np.argmax(ref, -1)).all()) for r in ranks]
    if max(errs) > tol or not all(picks):
        bad.append(f"{label}: ranks {errs} from one card rank (tol {tol}), picks equal "
                   f"{picks}")
    if cpu_err > RANGE_TOL * scale:
        bad.append(f"{label}: card {cpu_err} from the CPU (tol {RANGE_TOL * scale})")
    card_launches = want_launches if card_launches is None else card_launches
    if any(x != want_launches for x in launches) or card["launches"] != card_launches:
        bad.append(f"{label}: launches {launches}, one rank {card['launches']}, "
                   f"want {want_launches}, one rank {card_launches}")
    return {"rank_err": errs, "rank_tol": tol, "picks_equal": picks, "card_vs_cpu": cpu_err,
            "logits_scale": scale, "rank_launches": launches}


def phase_reference_ring(gloo=True):
    """The SP prefill on the tiny f32 model (2 layers, 2 kv heads, head_dim
    128): four processes on this card over gloo as a 2 x 2 ("data",
    "model") mesh (one spawn), each case at sp=2 x tp=2 and at sp=2 (each
    "model" index a replica), the dense cache and the masked cache under
    every method family of the prune (RING_METHODS), a prompt of 512 (true
    length 500) over B=4, then 4 decode steps through kernel 4
    (``use_pallas``; with ``return_norm`` for the Opa values): every rank's
    logits within SP_TOL of one card rank's (``sp_case`` without a mesh;
    RANGE_TOL of their range at tp=2, ``_hold_ranks``) and its greedy picks
    equal, that rank's within RANGE_TOL of the CPU's (kernel 4's plain
    version), and kernel 4 launched 2 layers x 4 steps by every rank.  On a
    host with four cards the same cases run over nccl, one card a rank
    (``gloo`` False: that leg alone)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.parallel import distributed as dr
    from mustafar_tpu_torch.parallel import ring
    counts0 = _launches()
    tokens = np.random.RandomState(6).randint(0, 512, (4, 512))
    cases = []
    for mode, method in RING_METHODS:
        eng = _tiny_parallel_engine(mode, method)
        for use_tp in (True, False):
            cases.append(dict(engine=eng, params=dr.init_params_np(eng.model, 6),
                              tokens=tokens, true_len=500, decode_steps=4, device="cuda",
                              use_pallas=True, use_tp=use_tp))
    legs = {}
    if gloo:
        legs["gloo"] = _spawned(RING + "sp_cases", 2, 2, {"cases": cases})
    if torch.cuda.device_count() >= 4:
        legs["nccl"] = _spawned(RING + "sp_cases", 2, 2, {"cases": cases}, backend="nccl",
                                device="cuda:{rank}")
    fields, bad = {}, []
    for i, case in enumerate(cases):
        if case["use_tp"]:
            one = dict(case, use_tp=False)
            card, cpu = ring.sp_case(None, **one), ring.sp_case(None, **dict(one, device="cpu"))
        label = "{}_{}{}".format(case["engine"].cache_mode.value,
                                 case["engine"].prune.method.value,
                                 "_tp2" if case["use_tp"] else "")
        for leg, (ranks, _) in legs.items():
            fields.setdefault(leg, {})[label] = _hold_ranks(
                f"{leg} {label}", [r[i] for r in ranks], card, cpu,
                {"flash_decode_attention": 2 * 4}, bad, cut_heads=case["use_tp"])
    _set_launches(counts0)
    nccl = fields.get("nccl", "not run: sp=2 x tp=2 over nccl needs four cards, this host "
                              f"has {torch.cuda.device_count()}")
    emit("reference_ring", mesh="sp=2 x tp=2 and sp=2", backend="gloo",
         processes_on_one_card=4, spawn_s={k: v[1] for k, v in legs.items()}, tol=SP_TOL,
         cpu_tol_of_range=RANGE_TOL, gloo_leg=fields.get("gloo"), nccl=nccl)
    if bad:
        raise AssertionError(f"reference_ring: {bad}")


SP_PROMPT = 8192
SP_STEPS = 16


def phase_serve_sp_prefill(model, gloo=True):
    """Llama-3-8B at full width and ``model``'s depth (CUT_LAYERS), W8
    random weights (init_params_w8, seed 0), B=2 prompts of SP_PROMPT
    tokens, the dense cache: the SP prefill at sp=2 (two processes on this
    card over gloo, each rank its 4,096-token block of both rows, the ring
    and the handoff), then SP_STEPS decode steps through kernel 4, each rank
    its row.  One rank's monolithic prefill (``llama.prefill`` one row at a
    time: its causal attention over 8,192 tokens at once) and decode on
    the same weights is the reference: first tokens equal, the prefill's
    and the first step's logits within TP_BF16_TOL of their range (the
    bound of a bf16 parallel run against one rank; on an H100 they sat
    1.6-1.7e-2 of their range from the monolithic prefill's), kernel 4 launched
    layers x steps by each rank.  One rank's ring prefill (``sp_case``
    without a mesh: the same flash arithmetic, one block) shows the spread
    of these bf16 logits under a reordering of the attention's sums alone:
    its distance from the monolithic prefill and from the SP ranks is
    printed beside theirs.  Each rank's prefill is run three times: to warm
    up, for its wall time, and with its hops and the handoff
    synchronize-bracketed (``p2p`` clock) for their ms and share.  On a
    host with two cards the same run over nccl, one card a rank (``gloo``
    False: that leg alone)."""
    import functools
    import numpy as np
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode, EngineConfig, PruneConfig, PruneMethod
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.models.quant import init_params_w8
    from mustafar_tpu_torch.parallel import ring
    counts0 = _launches()
    eng = EngineConfig(model=model, cache_mode=CacheMode.DENSE,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.0,
                                         v_sparsity=0.0),
                       max_seq_len=8448, batch_size=2)
    tokens = np.random.RandomState(0).randint(1, model.vocab_size, (2, SP_PROMPT))
    case = dict(engine=eng, params=functools.partial(init_params_w8, model, None, None, 0),
                tokens=tokens, decode_steps=SP_STEPS, dtype=torch.bfloat16, device="cuda",
                use_pallas=True, time_hops=True, use_tp=False)
    legs = {}
    if gloo:
        legs["gloo"] = _spawned(RING + "sp_case", 2, 1, case)
    if torch.cuda.device_count() >= 2:
        legs["nccl"] = _spawned(RING + "sp_case", 2, 1, case, backend="nccl",
                                device="cuda:{rank}")
    # one rank's monolithic prefill, a row at a time, then the same decode
    t = time.perf_counter()
    params = init_params_w8(model, None, None, 0)
    impl = make_cache(eng, device="cuda")
    impl.use_pallas = True
    cache = impl.init(2, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    first, prefill_s = [], []
    _set_launches({k: 0 for k in counts0})
    with torch.inference_mode():
        for b in range(2):
            sub = impl.init(1, torch.bfloat16)
            torch.cuda.synchronize()
            tb = time.perf_counter()
            lg, sub = llama.prefill(model, params, torch.as_tensor(tokens[b:b + 1]).cuda(), sub,
                                    impl, SP_PROMPT, last_only=True)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - tb)
            impl.insert_slot(cache, sub, b)
            first.append(lg[0, 0].float())
            del sub
        steps = [torch.stack(first).cpu().numpy()]
        tok = torch.argmax(torch.stack(first), -1)
        for i in range(SP_STEPS):
            lg, cache = llama.decode_step(model, params, tok[:, None], cache, impl,
                                          SP_PROMPT + i)
            steps.append(lg[:, 0].float().cpu().numpy())
            tok = torch.argmax(lg[:, 0], -1)
    one_launches = {k: v for k, v in _launches().items() if v}
    one_peak = torch.cuda.max_memory_allocated()
    one_s = time.perf_counter() - t
    del cache, impl
    torch.cuda.empty_cache()
    ring1 = ring.sp_case(None, **dict(case, params=lambda: params, decode_steps=1,
                                      time_hops=False))
    del params
    torch.cuda.empty_cache()
    L = model.num_layers
    want = {"flash_decode_attention": L * SP_STEPS}
    scale = float(np.abs(steps[1]).max())
    fields, bad = {}, []
    for leg, (ranks, spawn_s) in legs.items():
        first_equal = [bool((np.argmax(r["prefill"], -1) == np.argmax(steps[0], -1)).all())
                       for r in ranks]
        prefill_err = [float(np.abs(r["prefill"] - steps[0]).max()) for r in ranks]
        step_err = [float(np.abs(r["decode"][0] - steps[1]).max()) for r in ranks]
        fields[leg] = dict(
            spawn_s=spawn_s, prefill_ms=[1e3 * r["prefill_s"] for r in ranks],
            hop_ms=[1e3 * r["hop_s"] for r in ranks], hops=[r["hops"] for r in ranks],
            hop_share_of_prefill=[r["hop_s"] / r["prefill_s"] for r in ranks],
            rank_peak_gib=[r["peak_bytes"] / 2 ** 30 for r in ranks],
            first_token_equal=first_equal, prefill_logits_max_abs_err=prefill_err,
            first_step_logits_max_abs_err=step_err,
            ranks_vs_one_rank_ring=[
                [float(np.abs(r["prefill"] - ring1["prefill"]).max()),
                 float(np.abs(r["decode"][0] - ring1["decode"][0]).max())] for r in ranks],
            token_agreement_with_one_rank=[
                float(np.mean([(np.argmax(a, -1) == np.argmax(b, -1)).mean()
                               for a, b in zip(_steps(r), steps)])) for r in ranks],
            rank_launches=[r["launches"] for r in ranks])
        if not all(first_equal) or max(prefill_err + step_err) > TP_BF16_TOL * scale:
            bad.append(f"{leg}: first tokens equal {first_equal}, logits {prefill_err} / "
                       f"{step_err} against {TP_BF16_TOL * scale}")
        if any(r["launches"] != want for r in ranks):
            bad.append(f"{leg}: launches {[r['launches'] for r in ranks]}, want {want}")
    if one_launches != want:
        bad.append(f"one rank launched {one_launches}, want {want}")
    _set_launches(counts0)
    emit("serve_sp_prefill", model=f"{model.name} x{L}L (CUT_LAYERS), W8 (random, seed 0)",
         mesh="sp=2", backend="gloo", processes_on_one_card=2, B=2, prompt=SP_PROMPT,
         decode_steps=SP_STEPS, cache="dense, kernel 4",
         timing="prefill_ms: a rank's second prefill (the first warms up); hop_ms: a "
                "third's ring hops and handoff, each synchronize-bracketed",
         one_rank_prefill_ms=[1e3 * x for x in prefill_s], one_rank_s=one_s,
         one_rank_peak_gib=one_peak / 2 ** 30, logits_scale=scale, tol=TP_BF16_TOL * scale,
         one_rank_ring_vs_monolithic=[float(np.abs(ring1["prefill"] - steps[0]).max()),
                                      float(np.abs(ring1["decode"][0] - steps[1]).max())],
         one_rank_launches=one_launches, gloo_leg=fields.get("gloo"),
         nccl=fields.get("nccl", "not run: sp=2 over nccl needs two cards, this host has "
                                 f"{torch.cuda.device_count()}"))
    if bad:
        raise AssertionError(f"serve_sp_prefill: {bad}")


PP_PROMPT, PP_NEW, PP_MICRO = 300, 32, 2


def phase_serve_pp(model, params, gloo=True):
    """Llama-3-8B at full width and ``model``'s depth, W8 random weights
    (init_params_w8, seed 0; ``params`` the same weights in this process),
    B=8 prompts of PP_PROMPT tokens, PP_NEW new tokens (the prefill's and
    PP_NEW - 1 decode steps), the dense cache with kernel 4: two pipeline
    stages (two processes on this card over gloo, each making the weights
    and keeping its half of the layers), PP_MICRO microbatches.  One rank
    running the same schedule as one stage is the reference: every token
    equal, the prefill's and first step's logits within RANGE_TOL of their
    range; kernel 4 launched (its layers x steps x microbatches) by each
    stage.  A decode step's wall ms (the even steps) and its hops' share
    (the odd steps, each hop synchronize-bracketed).  Then PP x TP on the
    tiny model: four processes as a 2 x 2 ("stage", "model") mesh, the
    dense and masked (KT_MAG_VT_OPA, kernel 4 with ``return_norm``)
    caches, every rank's picks equal to one card rank's and its logits
    within RANGE_TOL of their range (the heads are cut, ``_hold_ranks``),
    that rank's within RANGE_TOL of the CPU's.  On a host with two cards
    (four for PP x TP) the same runs over nccl, one card a rank (``gloo``
    False: those legs alone)."""
    import functools
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, EngineConfig, PruneConfig, PruneMethod
    from mustafar_tpu_torch.models.quant import init_params_w8
    from mustafar_tpu_torch.parallel import distributed as dr
    from mustafar_tpu_torch.parallel import pipeline as pp
    counts0 = _launches()
    eng = EngineConfig(model=model, cache_mode=CacheMode.DENSE,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.0,
                                         v_sparsity=0.0),
                       max_seq_len=384, batch_size=8)
    tokens = np.random.RandomState(0).randint(1, model.vocab_size, (8, PP_PROMPT))
    case = dict(engine=eng, params=functools.partial(init_params_w8, model, None, None, 0),
                tokens=tokens, decode_steps=PP_NEW - 1, n_micro=PP_MICRO,
                dtype=torch.bfloat16, device="cuda", use_pallas=True, use_tp=False,
                time_hops=True)
    legs = {}
    if gloo:
        legs["gloo"] = _spawned(PIPE + "pp_case", 2, 1, case, axes=pp.STAGE_AXES)
    if torch.cuda.device_count() >= 2:
        legs["nccl"] = _spawned(PIPE + "pp_case", 2, 1, case, axes=pp.STAGE_AXES,
                                backend="nccl", device="cuda:{rank}")
    t = time.perf_counter()
    one = pp.pp_case(None, **dict(case, params=lambda: params))
    one_s = time.perf_counter() - t
    L, steps = model.num_layers, PP_NEW - 1
    ref = _steps(one)
    scale = float(np.abs(ref[1]).max())
    want = {"flash_decode_attention": L // 2 * steps * PP_MICRO}

    def step_split(r):
        d = np.asarray(r["decode_s"][1:])           # the first step warms up
        even, odd = d[1::2], d[0::2]                # steps 2, 4, ... untimed
        hop = r["decode_hop_s"] / max(1, len(r["decode_s"]) // 2)
        return {"step_ms_untimed_mean": 1e3 * float(even.mean()),
                "step_ms_timed_mean": 1e3 * float(odd.mean()),
                "hop_ms_per_step": 1e3 * hop, "hops_per_step":
                    r["decode_hops"] / max(1, len(r["decode_s"]) // 2),
                "hop_share_of_untimed_step": 1e3 * hop / (1e3 * float(even.mean())),
                "prefill_ms": 1e3 * r["prefill_s"],
                "prefill_hop_ms": 1e3 * r["prefill_hop_s"],
                "peak_gib": r["peak_bytes"] / 2 ** 30}

    fields, bad = {}, []
    for leg, (stages, spawn_s) in legs.items():
        tokens_equal = [bool((np.argmax(_steps(r), -1) == np.argmax(ref, -1)).all())
                        for r in stages]
        errs = [float(np.abs(_steps(r)[:2] - ref[:2]).max()) for r in stages]
        launches = [r["launches"] for r in stages]
        fields[leg] = dict(spawn_s=spawn_s, per_stage=[step_split(r) for r in stages],
                           tokens_equal_one_rank=tokens_equal, logits_max_abs_err=errs,
                           stage_launches=launches)
        if not all(tokens_equal) or max(errs) > RANGE_TOL * scale:
            bad.append(f"{leg}: tokens equal {tokens_equal}, logits {errs} against "
                       f"{RANGE_TOL * scale}")
        if any(x != want for x in launches):
            bad.append(f"{leg}: stage launches {launches}, want {want}")
    if one["launches"] != {"flash_decode_attention": L * steps * PP_MICRO}:
        bad.append(f"one rank launched {one['launches']}")

    # PP x TP on the tiny model: one spawn of four ranks a leg
    tiny_tokens = np.random.RandomState(7).randint(0, 512, (4, 200))
    tiny = [dict(engine=_tiny_parallel_engine(mode, method), tokens=tiny_tokens,
                 params=dr.init_params_np(_tiny_parallel_engine(mode, method).model, 7),
                 decode_steps=4, n_micro=2, device="cuda", use_pallas=True, use_tp=True)
            for mode, method in (("DENSE", "KT_MAG_VT_MAG"), ("MASKED", "KT_MAG_VT_OPA"))]
    tiny_legs = {}
    if gloo:
        tiny_legs["gloo"] = _spawned(PIPE + "pp_cases", 2, 2, {"cases": tiny},
                                     axes=pp.STAGE_AXES)
    if torch.cuda.device_count() >= 4:
        tiny_legs["nccl"] = _spawned(PIPE + "pp_cases", 2, 2, {"cases": tiny},
                                     axes=pp.STAGE_AXES, backend="nccl", device="cuda:{rank}")
    tiny_fields = {}
    for i, c in enumerate(tiny):
        one_c = dict(c, use_tp=False)
        card, cpu = pp.pp_case(None, **one_c), pp.pp_case(None, **dict(one_c, device="cpu"))
        mode = c["engine"].cache_mode.value
        for leg, (ranks, _) in tiny_legs.items():
            # a stage one layer, the card rank both, 4 steps of 2 microbatches
            tiny_fields.setdefault(leg, {})[mode] = _hold_ranks(
                f"tiny {leg} {mode}", [r[i] for r in ranks], card, cpu,
                {"flash_decode_attention": 1 * 4 * 2}, bad,
                {"flash_decode_attention": 2 * 4 * 2}, cut_heads=True)
    _set_launches(counts0)
    emit("serve_pp", model=f"{model.name} x{L}L, W8 (random, seed 0)", mesh="pp=2",
         backend="gloo", processes_on_one_card=2, B=8, prompt=PP_PROMPT, new_tokens=PP_NEW,
         n_micro=PP_MICRO, cache="dense, kernel 4", one_rank_s=one_s,
         one_rank=step_split(one), logits_scale=scale, tol=RANGE_TOL * scale,
         want_launches=want,
         timing="decode steps after the first: even ones wall time, odd ones with every "
                "hop synchronize-bracketed",
         gloo_leg=fields.get("gloo"),
         nccl=fields.get("nccl", "not run: pp=2 over nccl needs two cards, this host has "
                                 f"{torch.cuda.device_count()}"),
         pp_x_tp={"mesh": "pp=2 x tp=2", "processes_on_one_card": 4,
                  "spawn_s": {k: v[1] for k, v in tiny_legs.items()},
                  "gloo_leg": tiny_fields.get("gloo"),
                  "nccl": tiny_fields.get("nccl", "not run: needs four cards, this host "
                                                  f"has {torch.cuda.device_count()}")})
    if bad:
        raise AssertionError(f"serve_pp: {bad}")


TRAIN_STEPS = 20


def phase_train_tiny():
    """Training on the card: step 1 of TINY_ACC (4 layers, hidden 256) on a
    batch of 8 x 2,048 (``make_training_batch``, seed 0), ``remat`` on,
    from the same f32 weights on the card and on the CPU in this process:
    the loss and the global gradient norm within TRAIN_TOL (relative).
    Then ``train`` on the card, TRAIN_STEPS steps at batch 8, seq 2,048:
    the mean loss of the last 5 steps under that of the first 5; its
    checkpoint read back by ``weights.load_ckpt`` on the card and on the
    CPU, where the ``Generator`` (dense cache) greedy-decodes a passkey row
    to the same 16 tokens."""
    import tempfile
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, EngineConfig, PruneConfig, PruneMethod
    from mustafar_tpu_torch.harness import tinylm
    from mustafar_tpu_torch.models.llama import init_params
    from mustafar_tpu_torch.runtime.generate import Generator
    from mustafar_tpu_torch.weights import load_ckpt
    counts0 = _launches()
    cfg = tinylm.TINY_ACC
    corpus = tinylm.load_corpus(seed=0)
    toks, wts = tinylm.make_training_batch(corpus, np.random.RandomState(0), 8, 2048)
    cpu_params = init_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    step1 = {}
    for dev in ("cuda", "cpu"):
        params = {k: ({kk: vv.to(dev).requires_grad_(True) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev).requires_grad_(True))
                  for k, v in cpu_params.items()}
        t = time.perf_counter()
        loss = tinylm.training_loss(cfg, params, torch.as_tensor(toks, device=dev).long(),
                                    torch.as_tensor(wts, device=dev), remat=True)
        loss.backward()
        grads = [p.grad for p in tinylm._leaves(params)]
        gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        step1[dev] = {"loss": float(loss.detach()), "grad_norm": gnorm,
                      "seconds": time.perf_counter() - t}
    rel = {k: abs(step1["cuda"][k] - step1["cpu"][k]) / abs(step1["cpu"][k])
           for k in ("loss", "grad_norm")}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        res = tinylm.train(tmp, steps=TRAIN_STEPS, batch=8, seq=2048, inner=5,
                           device="cuda", log=lambda *a: None)
        train_s = time.perf_counter() - t
        outs = {}
        row = tinylm.make_passkey_row(corpus, np.random.RandomState(1), 1000)
        ids = tinylm.ByteTokenizer().encode(row["context"] + tinylm.PASSKEY_QUESTION,
                                            add_special_tokens=True)
        for dev in ("cuda", "cpu"):
            mcfg, p = load_ckpt(tmp, device=dev)
            eng = EngineConfig(model=mcfg, cache_mode=CacheMode.DENSE,
                               prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                                 k_sparsity=0.0, v_sparsity=0.0),
                               max_seq_len=1536)
            outs[dev] = Generator(eng, p, dtype=torch.float32, device=dev).generate(
                np.asarray([ids]), 16)[0].tolist()
    losses = res["losses"]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
    _set_launches(counts0)
    emit("train_tiny", model="tiny-acc (4 layers, hidden 256, f32)", batch=8, seq=2048,
         remat=True, step1=step1, step1_rel_err=rel, tol=TRAIN_TOL, steps=TRAIN_STEPS,
         losses=losses, first5_mean=first5, last5_mean=last5,
         step_ms=[1e3 * s for s in res["step_s"]],
         step_ms_median_after_first=1e3 * float(np.median(res["step_s"][1:])),
         train_s=train_s, passkey_prompt=len(ids), decoded_card=outs["cuda"],
         decoded_cpu=outs["cpu"], launched=launched)
    if max(rel.values()) > TRAIN_TOL or not last5 < first5:
        raise AssertionError(f"train_tiny: step 1 card/CPU {rel} (tol {TRAIN_TOL}), loss "
                             f"{first5} -> {last5}")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"train_tiny: the card decoded {outs['cuda']}, the CPU "
                             f"{outs['cpu']}")


QUANT_KINDS = ("decode", "decode_ps", "segment")


def _merge_codecs(entries, other, top, rest, note):
    """The kernels line keeps one entry per kernel: the decode, per-slot and
    segment kernels of a codec family carry codec ``top``'s numbers at the
    top and each codec's (``top`` and ``rest``) under ``codecs``."""
    keys = ("launches", "max_abs_err", "worst_err_over_tol", "ms", "plain_ms",
            "bound_ms", "bound_by")
    for kind in QUANT_KINDS:
        e = entries[(top, kind)]
        e["codecs"] = {c: {k: x[k] for k in keys}
                       for c, x in ((top, e), *((c, other[(c, kind)]) for c in rest))}
        for c in rest:                # each codec's sliding window
            e["codecs"][c]["window"] = other[(c, kind)]["options"]["window"]
        e["max_abs_err"] = max(v["max_abs_err"] for v in e["codecs"].values())
        e["worst_err_over_tol"] = max(v["worst_err_over_tol"] for v in e["codecs"].values())
        e["timed_at"] = f"{top} at the top; each codec under codecs"
        e["launches_note"] = note


def main():
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    smi = phase_env()
    phase_build()
    kinds = (("decode", phase_kernel), ("decode_ps", phase_kernel_ps),
             ("segment", phase_kernel_seg))
    entries = {(codec, kind): phase(codec) for codec in ("q8q4", "bitmap")
               for kind, phase in kinds}
    other = {(codec, kind): phase(codec) for codec in ("q8", "q4q4", "bitmap-q8")
             for kind, phase in kinds}
    entries[("q8q4", "pack")] = phase_kernel_pack()
    entries[("w4", "matmul")] = phase_kernel_w4()
    entries[("dense", "decode")] = phase_kernel_dense()
    entries.update(phase_kernel_archive())
    phase_reference()
    phase_reference_cb()
    phase_reference_bitmap()
    phase_reference_bitmap("bitmap-q8")
    q_engine_launches = phase_reference_q()
    phase_reference_w4()
    phase_reference_masked()
    phase_reference_opa()
    opa_cb_launches = phase_reference_opa_cb()
    swa_runs = phase_reference_swa()
    swa_cb_runs = phase_reference_swa_cb()
    phase_reference_sample()
    phase_reference_w8a8()
    phase_reference_moe()
    phase_reference_sharded()
    phase_dist_recovery()
    phase_reference_ring()

    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, LLAMA3_8B
    from mustafar_tpu_torch.models.quant import init_params_w8, weight_bytes
    t = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = init_params_w8(LLAMA3_8B, g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompt = np.random.RandomState(0).randint(1, LLAMA3_8B.vocab_size, (8, 300))
    new = 300
    decode_steps = new - 1
    expected = LLAMA3_8B.num_layers * decode_steps
    sparse_toks, launches, fields = serve("serve_q8q4", CacheMode.COMPRESSED,
                                          params, prompt, new, step_ms=True)
    graphed = {"q8q4": (sparse_toks, launches, fields)}
    q8q4_s = fields["seconds"]
    want = {"fused_q_decode_attention": expected, "prune_quant_pack_kv": serve_packs()}
    emit("serve_q8q4", model="llama-3-8b x32L, W8 (random, seed 0)",
         weights_gib=weight_bytes(params) / 2 ** 30, weights_init_s=init_s,
         decode_steps=decode_steps, expected_launches=want, **fields)
    if launches != want:
        raise AssertionError(f"kernels launched {launches}, expected {want}: 32 layers x "
                             f"{decode_steps} steps of the decode kernel, and kernel 9")
    entries[("q8q4", "decode")]["launches"] = expected
    entries[("q8q4", "pack")]["launches"] = launches["prune_quant_pack_kv"]
    kept = {}          # K and V rows 0-799 of the dense cache, for the archive
    dense_toks, dense_launches, fields = serve(
        "serve_dense", CacheMode.DENSE, params, prompt, new, step_ms=True,
        on_cache=lambda c: kept.update(k=c["k"][:, :, :800].clone(),
                                       v=c["v"][:, :, :800].clone()))
    graphed["dense"] = (dense_toks, dense_launches, fields)
    if dense_launches:
        raise AssertionError(f"the dense engine launched {dense_launches}")
    # the first token comes from prefill logits, the same in both engines
    first_equal = bool((sparse_toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_dense", first_token_equal=first_equal,
         token_agreement_with_q8q4=(sparse_toks == dense_toks).float().mean().item(),
         **fields)
    if not first_equal:
        raise AssertionError("sparse and dense engines disagree on the first token")
    dense_s = fields["seconds"]
    archive_launches = phase_kernel_archive_cache(kept.pop("k"), kept.pop("v"))
    for kind in ARCHIVE_KINDS:
        entries[("archive", kind)]["launches"] = archive_launches[_meta("archive", kind)[0]]
    bitmap_toks, launches, fields = serve("serve_bitmap", CacheMode.COMPRESSED, params,
                                          prompt, new, codec="bitmap", step_ms=True)
    graphed["bitmap"] = (bitmap_toks, launches, fields)
    first_equal = bool((bitmap_toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_bitmap", decode_steps=decode_steps, expected_launches=expected,
         first_token_equal_dense=first_equal,
         token_agreement_with_q8q4=(bitmap_toks == sparse_toks).float().mean().item(),
         token_agreement_with_dense=(bitmap_toks == dense_toks).float().mean().item(),
         **fields)
    if launches != {"fused_sparse_decode_attention": expected}:
        raise AssertionError(f"serve_bitmap: kernels launched {launches}, expected "
                             f"{expected} of the bitmap decode kernel")
    if not first_equal:
        raise AssertionError("bitmap and dense engines disagree on the first token")
    entries[("bitmap", "decode")]["launches"] = expected
    bitmap_fields = fields
    toks, launches, fields = serve("serve_bitmap_q8", CacheMode.COMPRESSED, params,
                                   prompt, new, codec="bitmap-q8")
    first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_bitmap_q8", decode_steps=decode_steps, expected_launches=expected,
         first_token_equal_dense=first_equal,
         token_agreement_with_bitmap=(toks == bitmap_toks).float().mean().item(),
         token_agreement_with_dense=(toks == dense_toks).float().mean().item(),
         serve_bitmap={k: bitmap_fields[k] for k in ("peak_mem_gib", "pool_bytes")},
         **fields)
    if launches != {"fused_sparse_decode_attention": expected} or not first_equal:
        raise AssertionError(f"serve_bitmap_q8: launched {launches} (expected {expected} "
                             f"of the bitmap decode kernel), first tokens equal the "
                             f"dense run's: {first_equal}")
    other[("bitmap-q8", "decode")]["launches"] = expected
    kernel_toks, launches, fields = serve("serve_dense_kernel", CacheMode.DENSE, params,
                                          prompt, new, use_pallas=True)
    first_equal = bool((kernel_toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_dense_kernel", decode_steps=decode_steps, expected_launches=expected,
         first_token_equal_dense=first_equal,
         token_agreement_with_dense=(kernel_toks == dense_toks).float().mean().item(),
         **fields)
    if launches != {"flash_decode_attention": expected} or not first_equal:
        raise AssertionError(f"serve_dense_kernel: launched {launches} (expected {expected} "
                             f"of the dense decode kernel), first tokens equal: {first_equal}")
    for codec in ("q8", "q4q4"):
        label = f"serve_{codec}"
        toks, launches, fields = serve(label, CacheMode.COMPRESSED, params, prompt, new,
                                       codec=codec)
        want = {"fused_q_decode_attention": expected, "prune_quant_pack_kv": serve_packs()}
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, decode_steps=decode_steps, expected_launches=want,
             first_token_equal_dense=first_equal,
             token_agreement_with_q8q4=(toks == sparse_toks).float().mean().item(),
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(),
             **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal the dense run's: {first_equal}")
        other[(codec, "decode")]["launches"] = expected
    serve_opa(entries, params, prompt, new, dense_toks)
    phase_serve_graph("serve_graph", params, prompt, new, graphed,
                      "llama-3-8b x32L, W8 (random, seed 0)")
    phase_decode_split(params, entries[("q8q4", "decode")]["kernel_ms"], q8q4_s,
                       dense_s, new)
    cb_runs = {}
    cut_model, cut_params = cut_depth(LLAMA3_8B, params)
    for codec in ("q8q4", "bitmap"):
        cb_launches, cb_runs[codec] = phase_serve_cb(cut_params, codec, model=cut_model,
                                                     eager_too=True)
        for kind in ("decode_ps", "segment"):
            entries[(codec, kind)]["launches"] = cb_launches[_meta(codec, kind)[0]]
    # bitmap-q8's graphed admission is held against the eager one by
    # serve_cb_bitmap's eager rerun (the same program at the other value
    # width) and host_split's (its cache state after segments, bit for bit)
    cb_launches, _ = phase_serve_cb(cut_params, "bitmap-q8", model=cut_model,
                                    beside={"serve_cb_bitmap": cb_runs["bitmap"]})
    for kind in ("decode_ps", "segment"):
        other[("bitmap-q8", kind)]["launches"] = cb_launches[_meta("bitmap-q8", kind)[0]]
    cb_launches, _ = phase_serve_cb(cut_params, "q4q4", first8=True, model=cut_model,
                                    eager_too=True)
    for kind in ("decode_ps", "segment"):
        name = _meta("q4q4", kind)[0]
        other[("q4q4", kind)]["launches"] = cb_launches[name]
        other[("q8", kind)]["launches"] = q_engine_launches["q8"][name]
    serve_cb_opa(entries, cut_params, cut_model, opa_cb_launches)
    phase_serve_cb_tp(cut_model)
    phase_serve_sp_prefill(cut_model)
    phase_serve_pp(LLAMA3_8B, params)
    _merge_codecs(entries, other, "q8q4", ("q8", "q4q4"),
                  "q8q4 and q4q4 from serve_q8q4 / serve_q4q4 and "
                  "serve_cb / serve_cb_q4q4; q8's per-slot and segment launches from "
                  "reference_q's engine run on the card (tiny model)")
    _merge_codecs(entries, other, "bitmap", ("bitmap-q8",),
                  "bitmap and bitmap-q8 from serve_bitmap / serve_bitmap_q8 and "
                  "serve_cb_bitmap / serve_cb_bitmap_q8")
    phase_serve_chunked(params)
    phase_host_split(cut_params, cut_model)
    phase_slot_core()
    serve_w8a8(cut_params, prompt, cut_model)
    phase_harness_predict(cut_params, cut_model)
    del params, cut_params
    torch.cuda.empty_cache()
    phase_harness_accuracy()
    phase_reference_harness()
    phase_train_tiny()
    serve_swa(entries, other, swa_runs, swa_cb_runs)
    serve_w4(entries, prompt, new)
    serve_moe()

    print(smi, flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
