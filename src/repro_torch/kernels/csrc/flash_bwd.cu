// FlashAttention-2 backward for Hopper (sm_90a), bf16 in, f32 gradients.
//
// Four kernels:
//
// fa2_bwd_delta_kernel replaces the Pallas TPU kernel
// src/repro/kernels/flash_bwd.py:80 flash_bwd_delta: delta = rowsum(dO o O)
// (Algorithm 2 line 4). It reads O and dO once and writes 4 bytes a row, so
// on an H100 it is bound by HBM (3.35 TB/s). It reads them in memory
// order: a CTA takes R consecutive positions (b, s) and every head of each,
// R * Hq * D * 2 contiguous bytes of a contiguous (B, Sq, Hq, D) tensor
// (the earlier design, a CTA per 64 positions of one head, read
// 256-byte pieces Hq * D * 2 bytes apart); the delta paragraph below says
// what bounds it now.
//
// fa2_bwd_fused_kernel replaces src/repro/kernels/flash_bwd.py:718
// flash_bwd_fused (compact body _fused_kernel_compact :672): dK, dV and dQ
// in one pass, with S and P recomputed once per visible tile. Five
// products per tile of 64 q rows x 64 kv rows at head_dim 128, so at
// training lengths it is bound by the tensor cores (989 TFLOP/s bf16), not
// by HBM. The TPU kernel is a sequential kv-major grid that zeroes each dq
// block at its first visit and adds to it on later visits; on Hopper CTAs
// run in parallel and in no order, so delta is the pre-pass above (it
// lives in HBM), dq is an f32 buffer the wrapper zeroes and every CTA adds
// into, and dK and dV are owned by one CTA each. Only the Hopper paths reach
// the tensor cores' rate: wgmma (mma.sync tops out well below it), TMA
// copies that cost the SMs no instructions, and warps that wait on
// mbarriers instead of CTA-wide barriers. The design, FlashAttention-3's
// backward at head_dim 128:
//   * one CTA per (pair of 64-row kv tiles j0 = 2m, j0 + 1, batch * kv
//     head): 384 threads, a producer warpgroup (one warp works; setmaxnreg
//     lowers it to 24 registers) and two consumer warpgroups (raised to
//     240), one per kv tile, each holding its tile's dK and dV as f32 wgmma
//     accumulators (64 + 64 registers a thread). Low pairs (the longest
//     causal walks) start first. An odd t_kv leaves the last CTA one tile;
//     its second warpgroup computes and writes nothing;
//   * the producer loads K and V (128 rows, 64 KB) once by TMA, then streams
//     Q_i and dO_i through a 2-stage ring: TMA boxes of 64 rows x 64
//     columns over 4-d (D, H, S, B) maps of the strided tensors, 128-byte
//     swizzled, rows past the end zero-filled, completion counted in bytes
//     on the stage's mbarrier; its lanes add the stage's lse (times log2 e,
//     +inf past Sq, 0 for -inf), delta and q ids, bound-checked, and a step
//     record (q head, q tile, which tiles take the step and which need the
//     element mask). Consumers release a stage on a second mbarrier;
//   * the producer walks the ascending union of the two tiles' CSR slices
//     per q head of the group (PairWalk; kernels/schedule.py pair_walk), or
//     under DENSE every q tile, classifying both tiles. A step is fetched if
//     either tile takes it; a warpgroup whose tile does not skips its
//     products (a decision uniform in the warpgroup). The consumers read no
//     table: they read the step record;
//   * per step and warpgroup (m64 = its 64 kv rows): S^T = K Q^T and
//     dP^T = V dO^T (wgmma m64n64k16, both operands from shared memory);
//     P^T = exp2(S^T log2 e - lse log2 e) with the element mask where the
//     step needs it (kHidden below keeps the finite mask value's P in the
//     log2 domain); dS^T = P^T o (dP^T - delta); dV += P^T dO and
//     dK += dS^T Q (m64n128k16, P^T and dS^T as bf16 A fragments from the
//     registers, dO and Q read MN-major). The accumulator fragment is the
//     mma.sync C layout, row 16 (warp % 4) + lane / 4 (+8), column
//     8 t + 2 (lane % 4) (+1), so the mask and the bf16 A fragments carry
//     over from the mma.sync design;
//   * dQ: both warpgroups write bf16 dS^T into a double-buffered 128 x 64
//     tile (swizzled like TMA's; a tile that does not take the step writes
//     zeros), meet at a named barrier, and each computes dQ_i = dS K for
//     half of head_dim over the pair's 128 kv rows (m64n64k16, both
//     operands MN-major). The 64 x 64 f32 half goes to padded shared
//     memory, and a writer warp of the producer warpgroup (one a consumer
//     warpgroup) adds it into dq with cp.reduce.async.bulk .add.f32, 256
//     bytes a row: 128 bulk reductions a step where the mma.sync kernel
//     issued 16,384 scalar atomics. An mbarrier pair hands the staging back
//     and forth, so no consumer waits on a bulk read it did not need. The
//     adds' order varies, so dQ is allclose-only; bwd="split" is the
//     deterministic mode.
// What bounds it now: the steps are serial within a warpgroup (S and dP,
// then P, dV, dS, dK, then the barrier and dQ) and the two warpgroups meet
// every step, so exp2 and the elementwise work sit between products; the
// dq reductions (a 64 MB f32 buffer at the training shape, more than the
// 50 MB L2) share the TMA engine and L2 with the Q/dO stream. One CTA an
// SM (about 200 KB of shared memory).
//
// Head_dim 64 (whisper-base, the gpt presets) is the same source with D a
// template argument, as in the forward: a 64-row tile is D / 64 TMA boxes,
// S^T and dP^T take D / 16 k-steps, dK and dV are 64 x D accumulators
// (wgmma_rs_k64<D> in sm90.cuh: m64n64k16 at 64). Its products are a
// quarter of 128's a step, so dQ's bytes and the producer weigh more; the
// fused kernel at 64 differs from 128 in two ways (D == 64 branches; the
// 128 code is as it was, and the dK/dV kernel at 64 is the 128 body):
//   * dQ once a step over the pair's 128 kv rows (m64n64k16, k 128, from
//     the shared dS^T buffer), by one warpgroup a dQ step in turn: half the
//     bulk reductions (a 64 x 64 f32 part, 16 KB, a step), where each
//     warpgroup added its own tile's 64 rows' part. Half of head_dim a
//     warpgroup, as at 128, would be an n32 product whose MN-major B starts
//     64 bytes into a 128-byte swizzled row, a layout this source does not
//     risk. The other warpgroup only arrives at the step's named barrier
//     (bar.arrive) and goes on; the barriers alternate with the turns (two
//     ids), so an arrival never completes the other turn's phase, and the
//     two dS^T buffers suffice: a buffer is written again two dQ steps on,
//     after its reader's next arrival (tools/model_bwd64_dq.py models the
//     hand-over; one barrier or one buffer breaks it). A warpgroup stages
//     every second part, so its writer warp has the other's turn to drain;
//   * warp 3 of the producer warpgroup (idle at 128) stages each step's lse
//     and delta rows (KvSmem::ROWS_WARP): it walks the producer warp's walk
//     again and arrives on the same full barrier, so the rows' load latency
//     (a lane's two rows one after the other) is no longer between a step's
//     copies and the next's; with dQ's bulk reductions filling the memory
//     system it held the fused kernel back (the dK/dV kernel spilled with
//     it and ran no faster).
// The walk, the products and their order into each accumulator are
// untouched, so split dK/dV stay bitwise the fused kernel's. About 132 KB
// of shared memory; one CTA an SM. What bounds it now (tools/ab_kernels.py
// hd64_*, PERF.md): the steps stay serial within a warpgroup (products,
// exp2, products, the dQ hand-over): two q tiles a step (m64n128 S^T and
// dP^T, k 128 dV and dK) measured slower, and so did leaving a step's dV
// and dK in flight under the next step's S^T in the fused kernel; a deeper
// Q/dO ring and more dQ staging buffers changed nothing. The dq and delta
// kernels take D = 64 as they take 128.
// Head_dims 256 (gemma3-1b training) and 160 (stablelm-12b) are
// instantiated in every mode (compact and DENSE, without and with SEG),
// with one change of shape in the KV-stationary and dq kernels, the `HALF`
// flag: a 64 x 256 f32 accumulator is 128 registers a consumer thread (at
// 160, 80), so a pair's dK and dV cannot fit setmaxnreg's 240, and at 256
// a pair's K and V (128 KB) with a 2-stage Q/dO ring (128 KB) exceed the
// 227 KB a CTA may use. So, as FlashAttention-3 does at 256, a
// KV-stationary CTA owns ONE 64-row kv tile and its two consumer
// warpgroups split the columns of dK and dV: at 256 w holds [128 w, 128 w
// + 128) (64 + 64 registers); at 160, which is not a whole number of
// 64-column TMA boxes (a tile is the forward's layout: two 128-byte
// swizzled boxes and a 64-byte-swizzled tail box of the last 32 columns,
// through a second tensor map per operand, load_tile, 20 KB a tile),
// warpgroup 0 holds box 0 and the tail (96 columns, 48 + 48 registers) and
// warpgroup 1 box 1. A split at column 80 would start an MN-major operand
// 32 bytes into a 128-byte swizzle atom, a layout this source does not
// risk. The one-tile design, against the plain pair walk above:
//   * the grid fills the card at one kv head: a CTA a tile leaves gemma3's
//     training shape (B 4, Hkv 1, t_kv 32) 128 CTAs, one wave whose causal
//     walks run 4 (32 - j) steps, twice the balanced share. Where the
//     wrapper finds the grid short (kernels/flash_bwd.py kv_head_split: fewer
//     CTAs than two waves and the longest walk over 1.5x the balanced
//     share), it splits the group's q heads over hsplit CTAs a tile (grid
//     (B * Hkv, hsplit, t_kv), blockIdx.y the share: read from the grid it
//     costs the 24-register producer no register), each walking its
//     p.hgroup heads and writing f32 dK/dV partials (B, Skv, Hkv * hsplit,
//     D), which fa2_bwd_group_sum_kernel below adds in a fixed order: no
//     atomics. gemma3's causal layers split one q head a CTA (512 CTAs);
//     its window layers (even walks) and stablelm (512 CTAs) do not;
//   * S^T and dP^T once a step: each warpgroup computes them for half of
//     the step's 64 q columns (n32 products over head_dim, Q's rows 32 w ..
//     read K-major from the stage: sm90.cuh kmajor_desc_half), writes its
//     bf16 P^T and dS^T halves into 64 x 64 shared buffers (128-byte
//     swizzled, the K-major A layout), and after one named barrier adds
//     P^T dO and dS^T Q into its columns with both operands from shared
//     memory (wgmma SS, wg_ss_k64). Five products of 64 x 64 x D a step
//     where the earlier design, both warpgroups computing the whole of S^T
//     and dP^T, made seven (the dK/dV kernel four where it made six). The
//     dS^T buffers alternate (the other warpgroup's dQ may still read the
//     last one), and so do the P^T buffers where the ring has two stages;
//     with one stage the producer refills it only once both warpgroups
//     have read this step's P^T, so one buffer serves (STG: below);
//   * dQ reductions that do not hold up the products: dQ_i += dS K over the
//     tile's rows, each warpgroup its columns (256: two 64-column parts;
//     160: box 0, or box 1 and the tail, 96 contiguous columns, so one
//     384-byte bulk reduction a row where two ran). The compact fused
//     kernel at 256 stages its f32 dQ in the Q/dO stage the step has just
//     consumed (KvSmem::STG: a stage is Q | dO | 4 KB): after a second
//     named barrier each warpgroup writes its 64 x 128 part into its half,
//     rows kStgRow floats apart, and its writer warp adds it into dq, 512
//     bytes a row, then frees the stage (stage_dq_writer). So its ring has
//     two stages where staging buffers left room for one, no consumer waits
//     on a writer, and one dS^T and one P^T buffer serve (the second
//     barrier keeps either warpgroup off them until the other has read
//     them). The others stage dQ in a ring of f32 buffers a warpgroup (at
//     160 one for warpgroup 0's 64 columns and two for warpgroup 1's 96;
//     the dense fused kernel at 256 two each, beside one Q/dO stage: with
//     two stages its producer warp spilled more than the earlier design),
//     which its writer warp drains in order (half_dq_writer): a consumer
//     waits only when its ring is full, and it releases the Q/dO stage
//     before the dQ product completes.
// Shared memory (KvSmem has the sums): at 256 the dK/dV kernel 225.9 KB,
// the fused kernel 217.9 KB (compact, two stages) and 225.1 KB (dense, one);
// at 160 153.9 and 223.9 KB. ptxas: 168 registers at entry, spills no more
// than the earlier design's (fused at 256: 64, SEG 88, DENSE 28, both 60
// bytes of spill stores, the compact ones now 48 and 80; at 160: 48, 80,
// 32, 68; dK/dV none), no serialised wgmma. The tail products at 160
// sit behind a branch on the warpgroup, broadcast from lane 0 so that
// ptxas sees it uniform (read from threadIdx.x instead, the earlier 160
// kernels took 1.24x and 1.32x, fused and dK/dV, and the 128 ones 1.12x
// and 1.17x: tools/ab_kernels.py kv_wg_thread on an H100 80GB HBM3 at
// 700 W). What bounds them now (tools/ab_kernels.py wide_*, an H100 80GB
// HBM3 at 700 W, in turns with the earlier design): the fused kernel at
// gemma3's causal shape takes 0.53x the earlier one's time (0.77x without
// the head split), at stablelm's 0.60x; without dQ's bulk reductions it
// takes 0.71x and 0.83x of its time; the steps stay serial within a
// warpgroup (products, exp2 and the exchange, products, the dQ staging),
// so the tensor cores idle between them.
//   * dq: at 256 one q tile a CTA (each warpgroup S and dP for half the
//     step's kv columns, and half of dQ's columns), at 160 the pair of q
//     tiles; the dq paragraph below has both.
// Split dK/dV stay bitwise the fused kernel's: one source, the DQ flag only
// adds the dQ phase and sets the ring depth (and the P^T buffers), which
// moves no arithmetic.
// SEG at 160 and 256 (packed training) is the 64/128 segment code: with
// HALF both warpgroups own the same kv rows (kw0 = k0), so both read the
// same kv ids and take the tile-0 flags; the CTA's walk is one kv tile's
// slice of the kv-major table (PairWalk with no second tile) for its
// share's heads, so its step bits are those of its tile; each stage's 64 q
// ids sit in the slot
// KvSmem reserves (beside the fused kernel's single 256 stage too); the dq
// kernel's HALF warpgroups hold the same q tile's ids. The element mask
// acts on S^T, dP^T (or S, dP) fragments, never on the accumulators split
// by columns. One change for every head dim: the KV-stationary consumers
// read their kv ids from shared memory inside the mask, indexed by the kv
// rows they hold anyway, rather than keep the ids (or their address) live
// through the step; with two more live registers ptxas serialised the fused
// SEG kernel's wgmma at 160 (PERF.md, row 8ls).
//
// The split backward (bwd="split", the deterministic mode) is the other
// two, with no atomics anywhere (the group sum, where the grid splits, is
// a fixed-order pass):
//
// fa2_bwd_dkv_kernel replaces src/repro/kernels/flash_bwd.py:234
// flash_bwd_dkv (compact body _dkv_kernel_compact :193): the fused
// kernel's body with the dS buffer, the dQ product and its staging compiled
// out (a template flag). Same CTA, walk, products and k-step order, so its
// dK and dV are bitwise the fused kernel's. Four products per tile: bound
// by the tensor cores.
//
// fa2_bwd_dq_kernel replaces src/repro/kernels/flash_bwd.py:459
// flash_bwd_dq (compact body _dq_kernel_compact :422). It is Q-stationary,
// the twin of the forward (csrc/flash_fwd.cu) built from the same sm90.cuh
// primitives: three products per visible tile (S = Q K^T, dP = dO V^T,
// dQ += dS K), so at training lengths it is bound by the tensor cores, and
// only wgmma fed by TMA reaches their rate. The design at head_dim 64,
// 128 and 160 (dq_pair):
//   * one CTA per (pair of 64-row q tiles 2m, 2m + 1, batch * q head): 384
//     threads, a producer warpgroup (one warp works; setmaxnreg lowers it to
//     24 registers) and two consumer warpgroups (raised to 240), one per q
//     tile, each holding its 64 rows' dQ as an f32 wgmma accumulator (64
//     registers a thread at 128, 80 at 160). High pairs (the longest causal
//     walks) start first. An odd t_q leaves the last CTA one tile; its
//     second warpgroup computes and writes nothing;
//   * the producer loads the pair's Q and dO once by TMA (the 4-d (D, H, S,
//     B) maps of the KV-stationary kernels), stages each row's lse (times
//     log2 e, with the fused kernel's kHidden rule for a row that sees no
//     key, +inf past Sq) and delta, then walks the ascending union of the
//     two q tiles' slices of the q-major table (PairWalk with group 1, as
//     the forward; kernels/schedule.py pair_walk), or under DENSE every kv
//     tile, which it classifies for both q tiles. K_j and V_j stream through
//     a 4-stage ring (3 at 160: 202 KB) with full and empty mbarriers, one
//     pair a stage; under SEG the kv tile's
//     ids follow by cp.async on the stage's barrier when a tile needs the
//     element mask. Each step is handed over as a record (kv tile; per q
//     tile: takes it, needs the element mask);
//   * per taken step and consumer warpgroup: S = Q K^T and dP = dO V^T
//     (wgmma m64n64k16, both operands from shared memory: Q, or Q and dO,
//     as register fragments measured no faster, tools/ab_kernels.py);
//     P = exp2(S log2 e - lse log2 e)
//     with the element mask where the record asks for it; dS = P o (dP -
//     delta), rounded to bf16 in registers as the A operand of dQ += dS K
//     (m64n128k16, K read MN-major);
//   * the warpgroup overlaps its own steps as the forward does: step j's S
//     and dP are issued together with step j - 1's dS K, and step j's
//     softmax and dS run while that product runs. The step record and the
//     warpgroup index are broadcast from lane 0, and every taken step issues
//     all three products (the first of a run with dS = 0, which adds exact
//     zeros), so ptxas sees uniform branches and no accumulator defined
//     between a product's issue and its wait, and serialises nothing;
//   * dQ is written once, in f32, from the accumulator: a warpgroup takes
//     exactly its own tile's steps in ascending kv order, with no atomics,
//     so dQ is bitwise the same from launch to launch, and dense dQ is the
//     compact dQ to the bit. A row that sees no key gets zeros.
// What bounds it (chip_smoke.py and tools/ab_kernels.py on an H100 80GB
// HBM3 at 700 W, training shape): it runs at 3.25x its bound. A 2-stage
// ring instead of 4 costs 1.27x, so the K/V stream matters; Q as register
// fragments changes nothing, Q and dO cost 1.04x. One CTA an SM (194 KB of
// shared memory), so a CTA's prologue and epilogue are not hidden; 64-column
// steps, so the waits and the record hand-over come every 64 keys; causal
// pairs finish unevenly in the last wave.
// At head_dim 160 and 256 the grid puts batch * head on x and the pair
// (160) or q tile (256), longest walks first, on y (dq_head_major;
// kernels/flash_bwd.py dq_grid; the wrapper refuses more than 65,535 on y):
// CUDA issues blocks x-fastest, so the first wave holds the longest causal
// walk of every head, where tiles on x put every tile of the first heads in
// it and the longest walks of the last heads in the last wave (gemma3's
// training shape: 32 tiles x 16 heads, one CTA an SM). At 64 and 128 the
// pairs stay on x (batch * head on x measured 0.93x there).
// At head_dim 256 (dq_wide, the same walk, records, mask, overlap and
// single write of dQ) the step and the rings differ:
//   * a 64 x 256 f32 dQ is 128 registers a thread, so a CTA owns ONE q tile
//     and warpgroup w holds columns [128 w, 128 w + 128) of its dQ; and S
//     and dP are computed once a step: warpgroup w computes them for its 32
//     of the step's 64 kv columns (m64n32 over head_dim, K's and V's rows
//     32 w .. read K-major from the stage: sm90.cuh kmajor_desc_half), its P
//     and dS = P o (dP - delta) with the element mask and SEG ids as above,
//     and writes its bf16 dS into a 64 x 64 shared slot (128-byte swizzled,
//     the K-major A layout); one named barrier; then each adds
//     dQ[:, 128 w ..] += dS K[:, 128 w ..] with both operands from shared
//     memory (m64n128, wg_ss_k64), issued with the next step's S and dP.
//     Three products of 64 x 64 x 256 a step where both warpgroups
//     computing the whole of S and dP made five; a consumer thread holds
//     64 + 16 + 16 accumulator registers (before, 64 + 32 + 32 and the
//     pending dS), so setmaxnreg gives the consumers 232 registers and the
//     producer warp 40 (with 24 it spilled under DENSE with SEG). The
//     slots alternate, and two suffice: a slot is written again two taken
//     steps on, after both warpgroups have passed the next step's barrier,
//     which each reaches only after its wait for the pending dQ += dS K
//     that reads the slot (tools/model_dq_wide.py models the hand-over: one
//     slot breaks it). A run's first product reads a tile of zeros the
//     producer wrote once (dQ += 0 exactly), so every taken step issues the
//     same three products;
//   * K and V on their own rings of full and empty mbarriers (the forward's
//     wide kernel does the same), K 3 stages and V 1 (Q/dO 64 KB + 96 + 32
//     KB + 24 KB of dS tiles: 217.3 KB): the producer loads K_j and hands
//     over the record (and, under SEG, the kv ids) on K's barrier, then
//     loads V_j. A consumer frees V_j once dP has completed, and K_j once the
//     dQ += dS K that reads it has, a step later; so V's one stage is
//     refilled while the step's dS and the pending dQ run, and K, held for
//     two steps, is loaded a step ahead. Every consumer waits on every
//     position of both rings, so no parity wait passes on a phase it
//     skipped.
// The order of the adds into each dQ element is the one above (k-steps of
// 16 over the step's 64 kv rows, ascending steps), so dQ stays bitwise the
// same from launch to launch, dense dQ the compact dQ, SEG with all-ones
// ids the unsegmented dQ, and every dQ the earlier design's. What bounds
// them now (tools/ab_kernels.py wide_dq, an H100 80GB HBM3 at 700 W, in
// turns with the earlier design): at gemma3's causal training shape the 256
// kernel takes 0.57x the earlier one's time (3.3x its bound), and undoing S
// and dP once costs 1.36x, the grid order 1.16x, the K/V split with its
// deeper K ring 1.11x; the split backward takes 1.14x SDPA's backward. The
// 160 kernel takes 0.88x the earlier one's time (2.9x its bound), all of it
// the grid order: K and V on their own rings in the pair body (K 4 stages,
// V 2) bought 1.05x unsegmented and lost 1.04x under SEG. The steps stay
// serial within a warpgroup (products, exp2 and dS, the barrier at 256),
// and one CTA an SM leaves a CTA's prologue and epilogue unhidden.
//
// Packed (varlen) batches take the SEG instantiation of the fused, dkv and
// dq kernels, which replaces the segment branches of the same Pallas
// kernels (flash_bwd.py:833, :330 and :539). Beside the table each reads
// int32 segment ids of q and kv and a (B, n_visible) table of per-step bits
// computed before the launch (kernels/schedule.py segment_step_bits, in
// the kernel's orientation), indexed by b = blockIdx.x / Hkv in the
// KV-stationary kernels and by b = bh / Hq in the dq kernel:
//   * a step without SEG_ACTIVE is skipped before its tiles are prefetched,
//     so it costs neither a copy nor a product. In both pair walks a tile's
//     entry without the bit is dropped from the union, and a step that
//     neither tile keeps is never fetched; the ring's stage alternates with
//     the count of fetched steps. Only the producer reads the bits;
//   * a step applies the element mask when it is flagged masked or lacks
//     SEG_UNIFORM, and the mask then also needs q_id == kv_id. The owner
//     tile's ids sit in registers (the dq kernel: two rows a thread) or in
//     shared memory (the KV-stationary kernels: its producer's lanes copy
//     the CTA's kv ids once, before K and V arrive); the streamed tile's
//     64 ids travel with it in the same stage (the KV-stationary
//     producer's lanes copy them; the dq producer's lanes by cp.async, only
//     when a tile needs the element mask). Rows past the end read as the
//     masks.py sentinels, or as 0 where the mask hides them anyway;
//   * a kv tile with no active step writes zero dK and dV, a q tile zero
//     dQ, as every CTA writes its whole tile anyway.
// The SEG code of the fused and dkv kernels is one source, so split dK and
// dV stay bitwise the fused kernel's. With SEG false the kernels are the
// ones described above.
//
// The DENSE instantiations of the fused, dkv and dq kernels (each with and
// without SEG) replace the dense bodies of the same Pallas kernels:
// _fused_kernel_dense (flash_bwd.py:633), _dkv_kernel_dense (:157) and
// _dq_kernel_dense (:390), segment branches included. They read no table
// and no step bits: a KV-stationary CTA walks, for each q head g of the
// group, every q tile i = 0 .. t_q - 1 (the (g, i) order of the JAX dense
// grid (BHk, t_kv, G, t_q), flash_bwd.py:291), a dq CTA every kv tile in
// ascending order. Each step fetches its tiles (Q and dO, or K and V, with
// SEG their ids) through the same ring, then the producer classifies the
// step for both tiles of its pair (classify_tile: the spec, q_offset and the
// ragged kv edge; with SEG the min and max of the owners' ids, reduced
// once, and of the staged ids, reduced with shuffles) and a warpgroup whose
// tile is empty there skips the step's products; in the KV-stationary
// kernels both tiles' classes decide whether the step has a dQ product. The
// cost of the hidden tiles' copies is the point: this is
// the baseline the compact schedule is measured against. Visible tiles
// come in the compact order with the compact mask decisions, so dense dK,
// dV and split dQ are the compact kernels' to the bit; the dense fused dQ
// goes through the same bulk reductions and agrees up to their order.
// At 160 and 256 (HALF in the KV-stationary kernels, and the dq kernel at
// 256) a CTA owns one tile, so the producer classifies that one only (and
// with SEG reduces only its ids); both warpgroups take its flags, as they
// take the table's on the compact schedule. The dq kernel at 160 keeps the
// pair of q tiles and classifies both. The consumers' step bodies are the
// compact ones, SEG element mask included, so nothing in them changes.
//
// The delta kernel is plain CUDA (16-byte loads and shuffles): it is bound
// by HBM and needs no tensor core. A CTA of 256 threads takes R positions
// and all their heads (R = 8, the 32-byte sector of its output runs,
// doubled while a CTA holds fewer than 256 rows and the grid still fills
// the 132 SMs once: 8 at the training shape, 32 at whisper's encoder and
// at gemma3's training shape, where D = 256 makes a row one warp);
// each thread has 4 16-byte loads of O and 4 of dO in flight before it
// reduces (53 registers: four CTAs an SM, so the training shape's 512 CTAs
// and the encoder's 376 run in one wave), a row's D / 8 threads, on a
// power-of-two group of lanes inside a warp (at D = 160, 20 of a warp's
// 32: a shuffle tree over 20 lanes would mix rows), finish it with shuffles
// in a fixed order (no atomics: bwd="split" stays bitwise run to run), and
// the R x Hq sums go out through shared memory as runs of R floats per
// head. A grid of one CTA per block of positions, not a
// persistent loop: several CTAs an SM overlap one another's latency.
// Strided views (a transposed dO) take the same path through their
// strides, out of memory order. What bounds it (tools/ab_kernels.py on an
// H100 80GB HBM3 at 700 W, training shape B 2, S 2048, 32 heads, D 128:
// bound 0.0202 ms; PERF.md has the runs): not the order of the reads (a
// head-major copy of the same data, read out of order, takes the same
// time, 0.97-1.00x, and so does the earlier walk of a CTA per head with
// the same loads, 0.96-1.01x); HBM's rate less a fixed cost of launch and
// tail (0.0279-0.0288 ms after a flush that only reads), and under the
// timing's L2 flush (zeroing 96 MB, which leaves L2 full of dirty lines)
// the write-back of those lines, which shares HBM with the reads. Loads
// marked evict-first in L2 replace the stream's own lines and leave most of
// the dirty ones in place: 0.0313-0.0323 ms, where plain loads take 1.14x.
//
// Semantics match the JAX kernels: masked scores take the finite
// DEFAULT_MASK_VALUE, K/V rows past the end read as zeros and are masked,
// a fully masked row's lse = -inf is replaced by 0 (P stays 0), P is
// rounded to bf16 before dV += P^T dO, dS before dK += dS^T Q and
// dQ += dS K. q is the pre-scaled q, so dQ is with respect to it. q rows
// past the end take lse = +inf, so their P is 0.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows of a streamed tile
constexpr int kBlockN = 64;  // kv rows a CTA owns
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct DeltaParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  float* delta;  // (B, Hq, Sq)
  long long o_sb, o_ss, o_sh;
  long long d_sb, d_ss, d_sh;
  int Hq, Sq;
  int R;  // positions a CTA
};

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // (B, Hq, Sq), raw (-inf on fully masked rows)
  const float* delta;  // (B, Hq, Sq)
  float* dq;           // (B, Sq, Hq, D); fused: zeroed by the caller, null
                       // skips dQ's staging and bulk reduction (a timing
                       // variant that isolates their cost); dq kernel:
                       // written once
  float* dk;           // (B, Skv, Hkv, D)
  float* dv;           // (B, Skv, Hkv, D)
  const int* table;    // kv-major: row_ptr[t_kv + 1], then (q_tile << 1) | masked;
                       // q-major (dq): row_ptr[t_q + 1], then (kv_tile << 1) | masked
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long d_sb, d_ss, d_sh;
  int Hq, Hkv, group, Sq, Skv, t_kv, t_q;
  int causal, window, sink, q_offset;  // window < 0: no window
  // SEG only: segment ids (batch strides q_seg_sb / kv_seg_sb) and the
  // (B, n_vis) SEG_* bits of the table's steps.
  const int* q_seg;
  const int* kv_seg;
  const int* bits;
  long long q_seg_sb, kv_seg_sb;
  int n_vis;
  // The KV-stationary kernels at 160 and 256: q heads a CTA takes. With
  // hgroup < group the group is split over hsplit = group / hgroup CTAs a
  // kv tile, each writing its dK and dV into dk, dv as partials (B, Skv,
  // Hkv * hsplit, D); hgroup = group: dk, dv themselves.
  int hgroup;
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// (empty, needs the element mask) of the tile of BM q positions from q_lo
// and BN kv rows from kv_lo: the dense schedule's in-kernel test, the JAX
// _visibility (flash_fwd.py:71) on inclusive corners (the forward's
// classify_tile, csrc/flash_fwd.cu). A tile that reaches past Skv needs the
// mask; one that starts past it is never walked.
struct TileClass {
  bool empty, mask;
};

__device__ __forceinline__ TileClass classify_tile(const BwdParams& p, int q_lo, int kv_lo) {
  const int q_hi = q_lo + kBlockM - 1, kv_hi = kv_lo + kBlockN - 1;
  bool empty = false, full = true;
  if (p.causal) {
    empty = q_hi < kv_lo;
    full = q_lo >= kv_hi;
    if (p.window >= 0) {
      empty = empty || (q_lo - kv_hi >= p.window && kv_lo >= p.sink);
      full = full && (q_hi - kv_lo < p.window || kv_hi < p.sink);
    }
  } else if (p.window >= 0) {
    empty = (q_lo - kv_hi >= p.window || kv_lo - q_hi >= p.window) && kv_lo >= p.sink;
    full = (abs(q_lo - kv_hi) < p.window && abs(q_hi - kv_lo) < p.window) || kv_hi < p.sink;
  }
  if (kv_lo + kBlockN > p.Skv) full = false;
  return {empty, !full};
}

// The id-range test on top: disjoint id ranges share no segment (empty); a
// tile is mask-free only if both tiles hold one and the same id.
__device__ __forceinline__ TileClass with_ids(TileClass c, int q_lo, int q_hi, int kv_lo,
                                              int kv_hi) {
  c.empty = c.empty || q_hi < kv_lo || q_lo > kv_hi;
  c.mask = c.mask || !(q_lo == q_hi && kv_lo == kv_hi && q_lo == kv_lo);
  return c;
}

// min and max of the N ids of rows [row0, row0 + N), rows at or past
// `nrows` counting as `pad` (from global memory: an owner tile's ids, read
// once by every thread).
template <int N>
__device__ __forceinline__ void id_range(const int* g, int row0, int nrows, int pad, int& lo,
                                         int& hi) {
  lo = hi = row0 < nrows ? g[row0] : pad;
  for (int r = 1; r < N; ++r) {
    const int id = row0 + r < nrows ? g[row0 + r] : pad;
    lo = min(lo, id);
    hi = max(hi, id);
  }
}

__device__ __forceinline__ bool visible(const BwdParams& p, int qpos, int col) {
  if (col >= p.Skv) return false;
  if (p.causal) {
    if (qpos < col) return false;
    return p.window < 0 || qpos - col < p.window || col < p.sink;
  }
  if (p.window < 0) return true;
  const int d = qpos > col ? qpos - col : col - qpos;
  return d < p.window || col < p.sink;
}

// ------------------------------------------------------------------ delta

constexpr int kDeltaThreads = 256;
constexpr int kDeltaUnroll = 4;  // rows of O and of dO a thread has in flight

// An L2 policy that marks the lines of a load evict-first: a stream read
// once replaces its own lines, not the rest of the cache.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint4 load_evict_first(const void* ptr, uint64_t policy) {
  uint4 v;
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(ptr), "l"(policy));
  return v;
}

// delta for R consecutive positions (b, s0 .. s0 + R - 1) and every head of
// each: R * Hq rows of D values, in the order they sit in a contiguous
// (B, Sq, Hq, D) tensor. A row is D / 8 16-byte chunks, one a thread, on a
// power-of-two group of TPR lanes inside one warp (D / 8 rounded up: at
// head_dim 160 a warp a row, whose lanes 20-31 load nothing and add 0);
// every thread issues its kDeltaUnroll loads of O and of dO before it
// reduces any. A row's sum is fixed: its 8 products per thread in order,
// then a shuffle tree over its TPR lanes. The R x Hq results are staged in
// shared memory and written to (B, Hq, Sq) as runs of R floats per head. O
// and dO are read once: their loads are evict-first in L2.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads) fa2_bwd_delta_kernel(const DeltaParams p) {
  constexpr int CH = D / 8;                               // 16-byte chunks a row
  constexpr int TPR = CH <= 8 ? 8 : CH <= 16 ? 16 : 32;  // threads per row
  static_assert(D % 8 == 0 && CH <= 32, "delta takes head_dim up to 256, a multiple of 8");
  constexpr int ROWS_PER_PASS = kDeltaThreads / TPR;
  extern __shared__ float s_delta[];          // [R][Hq]
  const int b = blockIdx.y, s0 = blockIdx.x * p.R;
  const int rows = p.R * p.Hq, live = min(p.R, p.Sq - s0) * p.Hq;
  const int c = threadIdx.x % TPR, r0 = threadIdx.x / TPR;
  const uint64_t policy = evict_first_policy();
  const __nv_bfloat16* og = p.o + b * p.o_sb + c * 8;
  const __nv_bfloat16* dg = p.dout + b * p.d_sb + c * 8;
  // The same trip count in every thread: the shuffles need whole warps.
  for (int base = 0; base < rows; base += kDeltaUnroll * ROWS_PER_PASS) {
    uint4 ov[kDeltaUnroll], dv[kDeltaUnroll];
#pragma unroll
    for (int u = 0; u < kDeltaUnroll; ++u) {
      const int row = base + u * ROWS_PER_PASS + r0;
      ov[u] = dv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (row < live && (CH == TPR || c < CH)) {
        const int s = s0 + row / p.Hq, h = row % p.Hq;
        ov[u] = load_evict_first(og + s * p.o_ss + h * p.o_sh, policy);
        dv[u] = load_evict_first(dg + s * p.d_ss + h * p.d_sh, policy);
      }
    }
#pragma unroll
    for (int u = 0; u < kDeltaUnroll; ++u) {
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[u]);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv[u]);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(o2[e]);
        const float2 d = __bfloat1622float2(d2[e]);
        acc += a.x * d.x + a.y * d.y;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int row = base + u * ROWS_PER_PASS + r0;
      if (c == 0 && row < live) s_delta[row] = acc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kDeltaThreads) {
    const int h = i / p.R, r = i % p.R;
    if (s0 + r < p.Sq)
      p.delta[(static_cast<long long>(b) * p.Hq + h) * p.Sq + s0 + r] = s_delta[r * p.Hq + h];
  }
}

// ------------------------------------------------------- fused and dkv

// The Hopper primitives (mbarriers, TMA, bulk reductions, named barriers,
// wgmma and its descriptors) and the pair walk live in sm90.cuh.

constexpr int kPairRows = 2 * kBlockN;  // kv rows of a KV-stationary CTA: two tiles
constexpr int kKvThreads = 3 * 128;     // producer warpgroup, two consumer warpgroups
constexpr int kConsumers = 2 * 128;
constexpr int kDqRow = 72;              // f32 dQ staging row: 64 values + 32 bytes of padding
constexpr int kStgRow = 136;            // the same in a Q/dO stage (KvSmem::STG): 128 values

// The kv rows a KV-stationary CTA owns: a pair of 64-row tiles, or at head_dim
// 160 and 256 one tile, whose two consumer warpgroups split head_dim.
template <int D>
constexpr int kv_rows() {
  return D == 160 || D == 256 ? kBlockN : kPairRows;
}
// A hidden element scores kHidden (sm90.cuh). A row that sees no key has
// lse = kMaskValue + log n, so P = exp(kMaskValue - lse) = 1 there; the
// producer stages such a row's lse as (kHidden + lse - kMaskValue) log2(e),
// the two terms scaled apart, and a hidden element's exp2(kHidden log2(e) -
// lse') is exp(kMaskValue - lse) on every row: 1 there, 0 elsewhere.

// The TMA maps of one launch: q, dO (64-row boxes) and k, v (128-row boxes
// in the KV-stationary kernels' pairs, else 64), each a 4-d (D, H, S, B)
// view of the strided tensor, 64 columns a box, 128-byte swizzled; at
// head_dim 160 also their tail maps, boxes of 64 rows x 32 columns (columns
// 128-159), 64-byte swizzled.
struct BwdMaps {
  CUtensorMap q, dout, k, v;
  CUtensorMap q_tail, dout_tail, k_tail, v_tail;
};

// The f32 dQ staging of consumer warpgroup w of a KV-stationary CTA (not
// the compact fused kernel at 256, which stages in its Q/dO stages:
// KvSmem::STG): its part of a step's dQ (the columns it adds into dq, 64,
// or at 160 in warpgroup 1 96), a staging row (the part and 32 bytes of
// padding), the buffers of its ring (2 at 256 and in warpgroup 1 at 160,
// else 1) and their offsets from the first.
template <int D>
__host__ __device__ constexpr int dq_cols(int w) { return D == 160 && w ? 96 : 64; }
template <int D>
__host__ __device__ constexpr int dq_row(int w) { return dq_cols<D>(w) + kDqRow - 64; }
template <int D>
__host__ __device__ constexpr int dq_nstg(int w) {
  return D == 256 || (D == 160 && w) ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr uint32_t dq_stg_bytes(int w) { return kBlockM * dq_row<D>(w) * 4; }
template <int D>
__host__ __device__ constexpr uint32_t dq_stg(int w, int buf) {
  return (w ? dq_nstg<D>(0) * dq_stg_bytes<D>(0) : 0) + buf * dq_stg_bytes<D>(w);
}

// Shared memory of the KV-stationary kernels, in bytes from a 1024-aligned
// base: K and V (D / 64 boxes of ROWS rows x 64 columns, BOX bytes apart,
// and at D = 160 a tail box of 64 rows x 32 columns), the Q/dO ring (a
// 64-row tile a stage, laid out the same way with 8 KB boxes), the bf16
// dS^T buffers (ROWS kv rows x 64 q; the pair kernels only with DQ) and, at
// 160 and 256, the bf16 P^T buffers the two warpgroups trade their halves
// through, with DQ the f32 dQ staging buffers of each consumer warpgroup,
// then each stage's lse, delta, q ids and step record, the CTA's kv ids,
// then the mbarriers and each staging buffer's (q0, head). About 200 KB at
// D = 128, 132 KB at D = 64. One kv tile a CTA (HALF):
//   * 256: dK/dV 2 stages, 2 + 2 buffers: 64 + 128 + 16 + 16 KB + 1.9 KB =
//     225.9 KB; compact fused (STG) 2 stages of Q | dO | 4 KB, 1 + 1
//     buffers: 64 + 136 + 8 + 8 KB + 1.9 KB = 217.9 KB; dense fused 1
//     stage, 2 dS^T buffers, 1 P^T buffer, 2 stagings of 64 x 72 floats a
//     warpgroup: 64 + 64 + 16 + 8 + 72 KB + 1.1 KB = 225.1 KB;
//   * 160: 20 KB tiles, 2 stages, 2 + 2 buffers: 40 + 80 + 16 + 16 KB + 1.9
//     KB = 153.9 KB for dK/dV; the fused kernel adds warpgroup 0's staging
//     (64 x 72 floats) and two of warpgroup 1 (64 x 104: its 96 columns):
//     223.9 KB.
// A CTA may use 227 KB (232,448 bytes) with the 1024 bytes of alignment.
template <int D, bool DQ, bool DENSE>
struct KvSmem {
  static constexpr bool HALF = D == 160 || D == 256;
  // The compact fused kernel at 256 stages its dQ in the Q/dO stage the
  // step has consumed (STG): a stage is laid out Q | dO | 4 KB, so that a
  // warpgroup's 64 x 128 f32 part, rows padded to kStgRow floats, fits in
  // its half; it needs no staging buffers, and one dS^T and one P^T buffer
  // (a second named barrier a step keeps both warpgroups off them until
  // the other has read them). The dense one keeps staging buffers and one
  // Q/dO stage: with two, its producer warp spilled more than before.
  static constexpr bool STG = D == 256 && DQ && !DENSE;
  // In the fused kernel at 64 warp 3 of the producer warpgroup stages each
  // step's lse and delta rows (the header's head_dim-64 paragraph);
  // elsewhere the producer warp (the dK/dV kernel at 64: with the rows warp
  // it spilled and ran no faster).
  static constexpr bool ROWS_WARP = D == 64 && DQ;
  static constexpr int ROWS = kv_rows<D>();
  static constexpr int STAGES = D == 256 && DQ && DENSE ? 1 : 2;  // the Q/dO ring
  static constexpr int NDS = STG ? 1 : HALF || DQ ? 2 : 0;       // dS^T buffers
  // P^T buffers. With one stage the producer refills it only once both
  // warpgroups have read its Q and dO, so neither writes the next step's
  // P^T before the other's dV has read this one.
  static constexpr int NPT = !HALF ? 0 : STG || STAGES == 1 ? 1 : 2;
  static constexpr int NDQB = HALF ? 4 : 2;  // dQ handshakes: (warpgroup, buffer or stage)
  static constexpr uint32_t BOX = ROWS * 128;     // a 64-column box of K or V
  static constexpr uint32_t KV = ROWS * D * 2;    // K or V of the CTA
  static constexpr uint32_t QT = kBlockM * D * 2;  // a Q or dO tile
  static constexpr uint32_t QSTR = STG ? 2 * QT + 4096 : QT;  // one stage's Q to the next's
  static constexpr uint32_t K = 0, V = KV, Q = 2 * KV, DO = STG ? Q + QT : Q + STAGES * QT;
  static constexpr uint32_t DS = STG ? Q + STAGES * QSTR : DO + STAGES * QT;
  static constexpr uint32_t PT = DS + NDS * BOX;
  static constexpr uint32_t DQS = PT + NPT * BOX;
  static constexpr uint32_t LSE = DQS + (DQ && !STG ? dq_stg<D>(1, dq_nstg<D>(1)) : 0);
  static constexpr uint32_t DELTA = LSE + STAGES * kBlockM * 4;
  static constexpr uint32_t QID = DELTA + STAGES * kBlockM * 4;
  static constexpr uint32_t STEP = QID + STAGES * kBlockM * 4;  // per stage: the step's record
  static constexpr uint32_t KVID = STEP + STAGES * 16;  // the CTA's kv ids (SEG)
  static constexpr uint32_t BARS = KVID + ROWS * 4;  // full, empty, kv, dq_full, dq_empty
  static constexpr uint32_t DQ_META = BARS + (2 * STAGES + 1 + 2 * NDQB) * 8;  // (q0, h) each
  static constexpr uint32_t BYTES = DQ_META + NDQB * 8;
  static_assert(BYTES + 1024 <= 232448, "a CTA may use 227 KB of shared memory");
};


// d (64 x DC) += A (64 x 64 bf16 at shared address a, 128-byte swizzled,
// K-major: the P^T or dS^T buffer both warpgroups wrote their halves of) *
// the columns of dK and dV that consumer warpgroup w of a one-tile CTA
// (HALF) holds, of the 64-row tile at shared address b (MN-major): at 256
// columns [128 w, 128 w + 128); at 160 box w (64 columns) and, in
// warpgroup 0, the tail (columns 128-159, into d[32 .. 47]). w is
// warp-uniform (broadcast), so ptxas sees the tail's branch as uniform.
template <int D, int DC>
__device__ __forceinline__ void wg_ss_k64(float (&d)[DC / 2], uint32_t a, uint32_t b, int w) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ak = sw128_desc(a + kk * 32, 16);
    if constexpr (D == 160) {
      wgmma_ss_n64<0, 1>(*reinterpret_cast<float(*)[32]>(d), ak,
                         sw128_desc(b + w * 8192 + kk * 2048, 8192), 1);
      if (w == 0)
        wgmma_ss_n32<0, 1>(*reinterpret_cast<float(*)[16]>(d + 32), ak,
                           sw64_desc(b + 2 * 8192 + kk * 1024, 4096), 1);
    } else {
      wgmma_ss_n128<0, 1>(d, ak, sw128_desc(b + w * 16384 + kk * 2048, 8192), 1);
    }
  }
}

// A dQ writer warp of a one-tile (HALF) fused kernel that stages dQ in
// buffers (not STG): warp 1 + W adds consumer warpgroup W's staged parts
// into dq by bulk reduction, in the order they were staged (buffer u %
// dq_nstg(W) of its ring, from shared address dqs + dq_stg(W, buffer)),
// then frees the buffer: at 256 (dense) a 64-column part, columns 128 W +
// 64 c for part c of a step (buffer c); at 160 box 0 (warpgroup 0, 256
// bytes a row) or box 1 and the tail (warpgroup 1, 96 contiguous columns,
// 384 bytes a row). (q0, head) = (-1, -1) ends the walk. W is a template
// argument, so the ring's shape takes none of the writer's 24 registers.
template <int D, int W>
__device__ __forceinline__ void half_dq_writer(const BwdParams& p, uint32_t dqs,
                                               uint64_t* dq_full, uint64_t* dq_empty,
                                               const int2* dq_meta, int b, int lane) {
  constexpr int NSTG = dq_nstg<D>(W);
  for (int u = 0;; ++u) {
    const int buf = u % NSTG;
    mbar_wait(&dq_full[2 * W + buf], (u / NSTG) & 1);
    const int2 m = dq_meta[2 * W + buf];
    if (m.x < 0) break;
    const int col = D == 256 ? (2 * W + buf) * 64 : W * 64;
    const uint32_t src = dqs + dq_stg<D>(W, 0) + buf * dq_stg_bytes<D>(W);
    for (int r = lane; r < kBlockM; r += 32)
      if (m.x + r < p.Sq)
        bulk_reduce_add(
            p.dq + ((static_cast<long long>(b) * p.Sq + m.x + r) * p.Hq + m.y) * D + col,
            src + r * dq_row<D>(W) * 4, dq_cols<D>(W) * 4);
    bulk_commit();
    bulk_wait_read();
    __syncwarp();
    if (lane == 0) mbar_arrive(&dq_empty[2 * W + buf]);
  }
}

// A dQ writer warp of the fused kernel at 256 (KvSmem::STG): warp 1 + W
// adds consumer warpgroup W's 64 x 128 f32 part of each step's dQ, staged
// in the step's Q/dO stage (its half of the stage, rows kStgRow floats
// apart), into dq's columns [128 W, 128 W + 128) by bulk reduction, 512
// bytes a row, then frees the stage for the producer (empty: both writers'
// lane 0). The stage of step u alternates; (q0, head) = (-2, 0): a step
// with no dQ, whose stage it frees at once; (-1, -1) ends the walk. The
// step's handshake barrier and record are its stage's, so a consumer
// cannot stage step u + 2 before this warp has read step u's.
template <int D, int W, class L>
__device__ __forceinline__ void stage_dq_writer(const BwdParams& p, uint32_t qs,
                                                uint64_t* dq_full, uint64_t* empty,
                                                const int2* dq_meta, int b, int lane) {
  for (int u = 0;; ++u) {
    const int stage = u % L::STAGES;
    mbar_wait(&dq_full[2 * stage + W], (u / L::STAGES) & 1);
    const int2 m = dq_meta[2 * stage + W];
    if (m.x == -1) break;
    if (m.x >= 0) {
      const uint32_t src = qs + stage * L::QSTR + W * (L::QSTR / 2);
      for (int r = lane; r < kBlockM; r += 32)
        if (m.x + r < p.Sq)
          bulk_reduce_add(
              p.dq + ((static_cast<long long>(b) * p.Sq + m.x + r) * p.Hq + m.y) * D + W * D / 2,
              src + r * kStgRow * 4, D / 2 * 4);
      bulk_commit();
      bulk_wait_read();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }
}

// The walk of a KV-stationary CTA (its kv tiles j0 and, if has1, j0 + 1;
// `group` q heads of batch row b): the kv-major table's slices, or under
// DENSE every q tile.
template <bool SKIP, bool DENSE>
__device__ __forceinline__ PairWalk<SKIP, DENSE> kv_walk(const BwdParams& p, int group, int j0,
                                                         bool has1, int b) {
  PairWalk<SKIP, DENSE> walk;
  walk.group = group;
  walk.n_tiles = (p.Sq + kBlockM - 1) / kBlockM;
  walk.g = 0;
  if (DENSE) {
    walk.steps = walk.bits = nullptr;
    walk.a0 = walk.a1 = walk.b0 = walk.b1 = 0;
  } else {
    walk.steps = p.table + p.t_kv + 1;
    walk.bits = SKIP ? p.bits + static_cast<long long>(b) * p.n_vis : nullptr;
    walk.a0 = p.table[j0];
    walk.a1 = p.table[j0 + 1];
    walk.b0 = has1 ? p.table[j0 + 1] : 0;
    walk.b1 = has1 ? p.table[j0 + 2] : 0;
  }
  walk.ia = walk.a0;
  walk.ib = walk.b0;
  return walk;
}

// The KV-stationary body: with DQ, the fused kernel; without, the dkv
// kernel (no dQ product, no staging; dK and dV bitwise the same). SEG: the
// segment variant of either. DENSE: every q tile, no table. D: head_dim,
// 64 or 128 (a pair of kv tiles a CTA) or 160 and 256 (HALF below).
template <int D, bool DQ, bool SEG, bool DENSE>
__device__ __forceinline__ void kv_stationary(const BwdParams& p, const BwdMaps& maps) {
  static_assert(D == 64 || D == 128 || D == 160 || D == 256,
                "the KV-stationary kernels take head_dim 64, 128, 160 or 256");
  using L = KvSmem<D, DQ, DENSE>;
  constexpr int S = L::STAGES;
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are skipped before their fetch
  // Head_dims 160 and 256: the CTA owns one kv tile and its two consumer
  // warpgroups split the columns of its dK and dV (the header says why):
  // at 256 w holds [128 w, 128 w + 128); at 160 warpgroup 0 holds box 0 and
  // the tail (96 columns), warpgroup 1 box 1 (64). Each computes S^T and
  // dP^T for half of a step's q columns and trades P^T and dS^T through
  // shared memory.
  constexpr bool HALF = L::HALF;
  constexpr int DC = !HALF ? D : D == 256 ? 128 : 96;  // (most) columns a warpgroup holds
  constexpr int BM = kBlockM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + S;
  uint64_t* kv_bar = empty + S;
  uint64_t* dq_full = kv_bar + 1;         // per staging buffer: a dQ part is staged
  uint64_t* dq_empty = dq_full + L::NDQB;  // the staging is read: it may be refilled
  int2* dq_meta = reinterpret_cast<int2*>(sm + L::DQ_META);
  float* sLse = reinterpret_cast<float*>(sm + L::LSE);  // lse * log2(e), +inf past Sq
  float* sDelta = reinterpret_cast<float*>(sm + L::DELTA);
  int* sQid = reinterpret_cast<int*>(sm + L::QID);
  int* sKvid = reinterpret_cast<int*>(sm + L::KVID);  // SEG: the ids of the CTA's kv rows
  // Per stage: (q head of the group, q tile, step flags); a negative head ends
  // the walk. The producer walks and classifies; the consumers read this.
  int4* sStep = reinterpret_cast<int4*>(sm + L::STEP);

  // blockIdx.x is (batch row, kv head). With HALF the group's q heads may
  // be split into hs = gridDim.y shares of p.hgroup heads, blockIdx.y the
  // CTA's, each writing the dK and dV of its heads into a partial of its
  // own (the wrapper sums the partials), and blockIdx.z is the kv tile; the
  // pair kernels take the whole group. (Read from the grid, the share costs
  // the producer warp no register: a share decoded from blockIdx.x by
  // division spilled the SEG kernels beyond their earlier design.)
  const int hs = HALF ? gridDim.y : 1, sp = HALF ? blockIdx.y : 0;
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int j0 = HALF ? blockIdx.z : 2 * blockIdx.y;  // low kv tiles (the longest causal runs) first
  const int k0 = j0 * kBlockN;
  const bool has1 = !HALF && j0 + 1 < p.t_kv;  // an odd t_kv leaves the last pair one tile
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // The producer warp's lanes (and the rows warp's); TMA bytes on top.
      mbar_init(&full[s], L::ROWS_WARP ? 64 : 32);
      // With STG the writer warps free a stage once they have read its dQ.
      mbar_init(&empty[s], L::STG && p.dq != nullptr ? 2 : kConsumers);
    }
    mbar_init(kv_bar, 1);
    for (int i = 0; i < L::NDQB; ++i) {
      mbar_init(&dq_full[i], 128);
      mbar_init(&dq_empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform (wg_ss_k64)
  if (wg == 0) {
    // Producer: one warp. K and V once; then, per step of the walk, Q_i and
    // dO_i by TMA (rows past Sq zero-filled), the stage's lse, delta and q
    // ids by the lanes, bound-checked, and the step's record.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      // The q heads of the CTA's share.
      PairWalk<SKIP, DENSE> walk = kv_walk<SKIP, DENSE>(p, HALF ? p.hgroup : p.group, j0, has1, b);
      if (SEG) {  // the CTA's kv ids, published by lane 0's arrival on kv_bar
        const int* kvid_g = p.kv_seg + b * p.kv_seg_sb;
        for (int r = lane; r < L::ROWS; r += 32)
          sKvid[r] = k0 + r < p.Skv ? kvid_g[k0 + r] : kKvPadSegment;
        __syncwarp();
      }
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         smem_u32(kv_bar)),
                     "r"(2 * L::KV)
                     : "memory");
        load_tile<D, L::BOX>(sm + L::K, maps.k, maps.k_tail, kv_bar, hk, k0, b);
        load_tile<D, L::BOX>(sm + L::V, maps.v, maps.v_tail, kv_bar, hk, k0, b);
      }
      const int* qid_g = SEG ? p.q_seg + b * p.q_seg_sb : nullptr;
      // DENSE with SEG: the id range of each kv tile the CTA owns (HALF:
      // one), read here once, but under HALF by the fused kernel only; the
      // dK/dV kernel with HALF reduces it from sKvid at every step (below).
      int kv_lo[2] = {0, 0}, kv_hi[2] = {0, 0};
      if (DENSE && SEG && (DQ || !HALF)) {
        const int* kvid_g = p.kv_seg + b * p.kv_seg_sb;
#pragma unroll
        for (int x = 0; x < 2; ++x)
          if (x == 0 || has1)
            id_range<kBlockN>(kvid_g, k0 + x * kBlockN, p.Skv, kKvPadSegment, kv_lo[x],
                              kv_hi[x]);
      }
      int g, qt, ea, eb;
      // (A `break` out of this loop crashes ptxas 12.9; the loop ends on `more`.)
      bool more = true;
      for (int n = 0; more; ++n) {
        more = walk.next(g, qt, ea, eb);
        const int stage = n % S;
        mbar_wait(&empty[stage], ((n / S) & 1) ^ 1);
        if (!more) {  // the walk's end: a record with a negative head, no copies
          if (lane == 0) sStep[stage] = make_int4(-1, 0, 0, 0);
          mbar_arrive(&full[stage]);
          continue;
        }
        const int h = hk * p.group + (HALF ? sp * p.hgroup : 0) + g, q0 = qt * BM;
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * L::QT);
          load_tile<D>(sm + L::Q + stage * L::QSTR, maps.q, maps.q_tail, &full[stage], h, q0, b);
          load_tile<D>(sm + L::DO + stage * L::QSTR, maps.dout, maps.dout_tail, &full[stage], h, q0,
                       b);
        }
        const long long row0 = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
        int lo = 0x7fffffff, hi = -0x7fffffff;
        if constexpr (L::ROWS_WARP) {
          // The rows warp stages lse and delta; this warp the q ids (SEG),
          // both of a lane's rows' loads in flight together.
          if (SEG) {
            int idr[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int qr = q0 + lane + 32 * u;
              idr[u] = qr < p.Sq ? qid_g[qr] : kQPadSegment;
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              sQid[stage * BM + lane + 32 * u] = idr[u];
              lo = min(lo, idr[u]);
              hi = max(hi, idr[u]);
            }
          }
        } else {
          for (int r = lane; r < BM; r += 32) {
            const int qr = q0 + r;
            float l = INFINITY, d = 0.f;
            if (qr < p.Sq) {
              l = p.lse[row0 + qr];
              l = l == -INFINITY        ? 0.f
                  : l < 0.5f * kMaskValue ? kHidden * kLog2e + (l - kMaskValue) * kLog2e
                                          : l * kLog2e;  // kHidden: a row that sees no key
              d = p.delta[row0 + qr];
            }
            sLse[stage * BM + r] = l;
            sDelta[stage * BM + r] = d;
            if (SEG) {
              const int id = qr < p.Sq ? qid_g[qr] : kQPadSegment;
              sQid[stage * BM + r] = id;
              if (!HALF) {
                lo = min(lo, id);
                hi = max(hi, id);
              }
            }
          }
        }
        // Which tiles take the step, and which need the element mask: the
        // table's flags and step bits, or under DENSE the classifier (with
        // SEG on both tiles' id ranges).
        int flags = 0;
        if (DENSE) {
          // With SEG the warp reduces the staged q tile's id range (under
          // HALF here, from sQid; else in the staging loop) and, with HALF,
          // the dK/dV kernel its kv tile's. Then the CTA's own tiles are
          // classified (under HALF, has1 false, one, whose flags both
          // warpgroups take), with HALF by lane 0 alone, the only lane that
          // writes the record. Under HALF these placements are ptxas's: with
          // the classifier in every lane it serialised the fused kernel's
          // wgmma at 160, and with the q range reduced in the staging loop,
          // the dK/dV kernel's kv range held in registers or the fused
          // kernel's reduced here, the kernels spilled beyond their compact
          // twins or serialised the fused kernel's wgmma at 160. The pair
          // kernels (64, 128) keep the other placements: with these their
          // dense dK/dV ran slower, timed in turns against them.
          if (SEG) {
            if (HALF) {
              __syncwarp();
              for (int r = lane; r < BM; r += 32) {
                lo = min(lo, sQid[stage * BM + r]);
                hi = max(hi, sQid[stage * BM + r]);
              }
            }
            warp_range(lo, hi);
            if (!DQ && HALF) {
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                if (x == 1 && !has1) continue;
                kv_lo[x] = min(sKvid[x * kBlockN + lane], sKvid[x * kBlockN + 32 + lane]);
                kv_hi[x] = max(sKvid[x * kBlockN + lane], sKvid[x * kBlockN + 32 + lane]);
                warp_range(kv_lo[x], kv_hi[x]);
              }
            }
          }
          if (!HALF || lane == 0) {
            TileClass c0 = classify_tile(p, q0 + p.q_offset, k0);
            TileClass c1 = {true, false};
            if (has1) c1 = classify_tile(p, q0 + p.q_offset, k0 + kBlockN);
            if (SEG) {
              c0 = with_ids(c0, lo, hi, kv_lo[0], kv_hi[0]);
              if (has1) c1 = with_ids(c1, lo, hi, kv_lo[1], kv_hi[1]);
            }
            if (!c0.empty) flags |= kTake0 | (c0.mask ? kMask0 : 0);
            if (has1 && !c1.empty) flags |= kTake1 | (c1.mask ? kMask1 : 0);
          }
        } else {
          if (ea >= 0)
            flags |= kTake0 | ((walk.steps[ea] & 1) || (SEG && !(walk.bits[ea] & kSegUniform))
                                   ? kMask0 : 0);
          if (eb >= 0)
            flags |= kTake1 | ((walk.steps[eb] & 1) || (SEG && !(walk.bits[eb] & kSegUniform))
                                   ? kMask1 : 0);
        }
        if (lane == 0) sStep[stage] = make_int4(g, qt, flags, 0);
        mbar_arrive(&full[stage]);
      }
    } else if (L::ROWS_WARP && threadIdx.x >= 96) {
      // The rows warp (warp 3; KvSmem::ROWS_WARP): the producer warp's walk
      // again, and per step the q tile's lse (times log2 e, the kHidden
      // rule, +inf past Sq) and delta rows into the stage, both of a lane's
      // rows' loads in flight together, then its arrival on the stage's
      // full barrier. Off the producer warp, their latency no longer comes
      // between a step's copies and the next's.
      const int lane = threadIdx.x % 32;
      PairWalk<SKIP, DENSE> walk = kv_walk<SKIP, DENSE>(p, p.group, j0, has1, b);
      bool more = true;
      for (int n = 0; more; ++n) {
        int g, qt, ea, eb;
        more = walk.next(g, qt, ea, eb);
        const int stage = n % S;
        mbar_wait(&empty[stage], ((n / S) & 1) ^ 1);
        if (more) {
          const int q0 = qt * BM;
          const long long row0 = (static_cast<long long>(b) * p.Hq + hk * p.group + g) * p.Sq;
          float l[2] = {INFINITY, INFINITY}, d[2] = {0.f, 0.f};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qr = q0 + lane + 32 * u;
            if (qr < p.Sq) {
              l[u] = p.lse[row0 + qr];
              d[u] = p.delta[row0 + qr];
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = lane + 32 * u;
            if (q0 + r < p.Sq)
              l[u] = l[u] == -INFINITY        ? 0.f
                     : l[u] < 0.5f * kMaskValue ? kHidden * kLog2e + (l[u] - kMaskValue) * kLog2e
                                                : l[u] * kLog2e;  // kHidden: a row that sees no key
            sLse[stage * BM + r] = l[u];
            sDelta[stage * BM + r] = d[u];
          }
        }
        mbar_arrive(&full[stage]);
      }
    } else if (DQ && threadIdx.x < 96 && p.dq != nullptr) {
      const int w = threadIdx.x / 32 - 1, lane = threadIdx.x % 32;
      if constexpr (L::STG) {
        const uint32_t qs = smem_u32(sm + L::Q);
        if (w == 0)
          stage_dq_writer<D, 0, L>(p, qs, dq_full, empty, dq_meta, b, lane);
        else
          stage_dq_writer<D, 1, L>(p, qs, dq_full, empty, dq_meta, b, lane);
      } else if constexpr (HALF) {
        const uint32_t dqs = smem_u32(sm + L::DQS);
        if (w == 0)
          half_dq_writer<D, 0>(p, dqs, dq_full, dq_empty, dq_meta, b, lane);
        else
          half_dq_writer<D, 1>(p, dqs, dq_full, dq_empty, dq_meta, b, lane);
      } else {
        // dQ writers: warp 1 + w adds consumer warpgroup w's staged 64 x 64
        // f32 part (D = 128: its half of head_dim; D = 64: its kv tile's
        // share of the whole row) into dq by bulk reduction, 256 bytes a
        // row, then frees the staging; (q0, head) = (-1, -1) ends the walk.
        const uint32_t stg = smem_u32(sm + L::DQS) + w * BM * kDqRow * 4;
        for (int u = 0;; ++u) {
          mbar_wait(&dq_full[w], u & 1);
          const int2 m = dq_meta[w];
          if (m.x < 0) break;
          const int col = D == 128 ? w * 64 : 0;
          for (int r = lane; r < BM; r += 32)
            if (m.x + r < p.Sq)
              bulk_reduce_add(
                  p.dq + ((static_cast<long long>(b) * p.Sq + m.x + r) * p.Hq + m.y) * D + col,
                  stg + r * kDqRow * 4, 256);
          bulk_commit();
          bulk_wait_read();
          __syncwarp();
          if (lane == 0) mbar_arrive(&dq_empty[w]);
        }
      }
      bulk_wait();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Consumer warpgroup w owns kv tile j0 + w: rows kw0 .. kw0 + 63 (HALF:
    // both own tile j0, w its columns of dK and dV, wg_ss_k64).
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int wq = t / 32, lane = t % 32, g8 = lane / 4, t4 = lane % 4;
    const int kw0 = k0 + (HALF ? 0 : w * kBlockN);
    const uint32_t rows_at = HALF ? 0 : w * 8192;  // pair: its kv rows inside a box of K or V
    const int kv_a = kw0 + wq * 16 + g8, kv_b = kv_a + 8;  // this thread's two kv rows
    const uint32_t sK = smem_u32(sm + L::K), sV = smem_u32(sm + L::V);
    const uint32_t sQ = smem_u32(sm + L::Q), sdO = smem_u32(sm + L::DO);
    const uint32_t sdS = smem_u32(sm + L::DS);
    const uint32_t stg = smem_u32(sm + L::DQS) + w * BM * kDqRow * 4;  // pair: f32 dQ staging

    // dV and dK of the tile: rows kv_a / kv_b, columns 8 tt + 2 t4 (+1)
    // (HALF: of the warpgroup's columns).
    float dv[DC / 2], dk[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dv[i] = dk[i] = 0.f;

    mbar_wait(kv_bar, 0);
    if constexpr (HALF) {
      // This thread's P^T and dS^T values sit in row R = 16 wq + g8 (kv row
      // kv_a) of the step's 64 x 64 buffers, q columns 32 w + 8 tt + 2 t4
      // (+1) for tt = 0 .. 3: 16-byte chunk 4 w + tt of the 128-byte
      // swizzled row, at x_at ^ (tt << 4); row R + 8 (kv_b) is 1024 bytes on.
      const uint32_t sPT = smem_u32(sm + L::PT);
      const uint32_t x_at = (wq * 16 + g8) * 128 + ((g8 ^ (4 * w)) << 4) + t4 * 4;
      // The dQ staging ring of the warpgroup (not STG): nstg buffers of 64
      // rows of dq_row(w) floats, this thread's rows R and R + 8 at stg_at.
      const int nstg = dq_nstg<D>(w);
      const uint32_t stg0 = smem_u32(sm + L::DQS + dq_stg<D>(w, 0));
      const uint32_t stg_at = ((wq * 16 + g8) * dq_row<D>(w) + 2 * t4) * 4;
      int n_x = 0;    // steps taken: the P^T and dS^T buffers alternate with it
      int n_stg = 0;  // dQ parts staged: the ring's position
      int n = 0;      // steps (STG: the writers' records follow them)
      for (;; ++n) {
        const int stage = n % S;
        mbar_wait(&full[stage], (n / S) & 1);
        // The record, broadcast from lane 0: ptxas then sees the branches
        // around the wgmmas as warp-uniform.
        int4 step = sStep[stage];
        step.x = __shfl_sync(0xffffffffu, step.x, 0);
        step.y = __shfl_sync(0xffffffffu, step.y, 0);
        step.z = __shfl_sync(0xffffffffu, step.z, 0);
        if (step.x < 0) break;
        if (!(step.z & kTake0)) {  // DENSE: the tile is empty there, no products
          if (L::STG && p.dq != nullptr) {  // the writers free the stage
            if (t == 0) dq_meta[2 * stage + w] = make_int2(-2, 0);
            mbar_arrive(&dq_full[2 * stage + w]);
          } else {
            mbar_arrive(&empty[stage]);
          }
          continue;
        }
        const int h = hk * p.group + sp * p.hgroup + step.x, q0 = step.y * BM;
        const bool masked = step.z & kMask0;
        const uint32_t cQ = sQ + stage * L::QSTR, cdO = sdO + stage * L::QSTR;
        const uint32_t cPT = sPT + (n_x % L::NPT) * L::BOX;
        const uint32_t cdS = sdS + (L::NDS == 1 ? 0 : n_x & 1) * L::BOX;
        {
          // S^T = K Q^T (line 11) and dP^T = V dO^T (line 13) for the
          // warpgroup's 32 q columns: n32 products over head_dim, K and V
          // laid out as a Q tile, tail box included; the two warpgroups
          // compute each element once.
          float s[16], dp[16];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n32<0, 0>(s, kmajor_desc<D>(sK, kk), kmajor_desc_half<D>(cQ, kk, w),
                               kk > 0);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n32<0, 0>(dp, kmajor_desc<D>(sV, kk), kmajor_desc_half<D>(cdO, kk, w),
                               kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);

          // P^T = exp2(S^T log2(e) - lse log2(e)); element i of n-block tt is
          // kv row kv_a (i < 2) or kv_b, q column q0 + cc + (i & 1). A hidden
          // element scores kHidden: P^T is exp(mask - lse), 1 on a row that
          // sees no key. The kv ids are read from shared memory here (the
          // header says why). Rounded to bf16 into the P^T buffer.
          const float* cl = sLse + stage * BM;
          const float* cd = sDelta + stage * BM;
          const int* cq = sQid + stage * BM;
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            const int cc = 32 * w + tt * 8 + 2 * t4;
            const float2 l2 = *reinterpret_cast<const float2*>(cl + cc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float x = s[4 * tt + i];
              if (masked) {
                bool v = visible(p, q0 + cc + (i & 1) + p.q_offset, i < 2 ? kv_a : kv_b);
                if (SEG)
                  v = v && cq[cc + (i & 1)] == sKvid[(i < 2 ? kv_a : kv_b) & (L::ROWS - 1)];
                if (!v) x = kHidden;
              }
              s[4 * tt + i] = exp2f(fmaf(x, kLog2e, -((i & 1) ? l2.y : l2.x)));
            }
            st_shared(cPT + (x_at ^ (tt << 4)), pack_bf16(s[4 * tt], s[4 * tt + 1]));
            st_shared(cPT + (x_at ^ (tt << 4)) + 1024, pack_bf16(s[4 * tt + 2], s[4 * tt + 3]));
          }
          wgmma_wait<0>();
          fence_regs(dp);
          // dS^T = P^T o (dP^T - delta) (line 14), rounded to bf16 into the
          // dS^T buffer.
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            const float2 d2 = *reinterpret_cast<const float2*>(cd + 32 * w + tt * 8 + 2 * t4);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dp[4 * tt + i] = s[4 * tt + i] * (dp[4 * tt + i] - ((i & 1) ? d2.y : d2.x));
            st_shared(cdS + (x_at ^ (tt << 4)), pack_bf16(dp[4 * tt], dp[4 * tt + 1]));
            st_shared(cdS + (x_at ^ (tt << 4)) + 1024, pack_bf16(dp[4 * tt + 2], dp[4 * tt + 3]));
          }
        }
        fence_async_smem();
        named_sync(1, kConsumers);  // both halves of P^T and dS^T are in their buffers
        // dV += P^T dO (line 12) and dK += dS^T Q (line 16), k over the
        // step's 64 q rows, into the warpgroup's columns.
        float dq[DQ ? (D == 256 ? 64 : 48) : 1];
        wgmma_fence();
        wg_ss_k64<D, DC>(dv, cPT, cdO, w);
        wg_ss_k64<D, DC>(dk, cdS, cQ, w);
        wgmma_commit();
        if constexpr (DQ) {
          // dQ_i += dS K_j (line 15) over the tile's 64 kv rows, dS read
          // MN-major from the dS^T buffer: at 256 the warpgroup's half of
          // head_dim as two 64-column parts (columns 128 w + 64 c into
          // dq[32 c ..]); at 160 box w, and in warpgroup 1 then the tail
          // (into dq[32 ..]).
#pragma unroll
          for (int c = 0; c < (D == 256 ? 2 : 1); ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n64<1, 1>(*reinterpret_cast<float(*)[32]>(dq + 32 * c),
                                 sw128_desc(cdS + kk * 2048, 8192),
                                 sw128_desc(sK + (D == 256 ? 2 * w + c : w) * 8192 + kk * 2048,
                                            8192),
                                 kk > 0);
          if (D == 160 && w == 1)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_n32<1, 1>(*reinterpret_cast<float(*)[16]>(dq + 32),
                                 sw128_desc(cdS + kk * 2048, 8192),
                                 sw64_desc(sK + 2 * 8192 + kk * 1024, 4096), kk > 0);
          wgmma_commit();
        }
        // dV and dK are done: this stage's Q and dO, and P^T, are read. P^T
        // and dS^T (which the other warpgroup's dQ may still read) alternate
        // between two buffers each; with STG, one each, and the second named
        // barrier below keeps either warpgroup from the next step's until
        // the other's products have read them.
        wgmma_wait<DQ ? 1 : 0>();
        fence_regs(dv);
        fence_regs(dk);
        if (!(L::STG && p.dq != nullptr)) mbar_arrive(&empty[stage]);
        if constexpr (L::STG) {
          wgmma_wait<0>();
          fence_regs(dq);
          // Both warpgroups are done with this stage's Q and dO: its memory
          // takes the step's dQ, the warpgroup's 128 columns in its half
          // (rows kStgRow floats apart), for its writer warp, which frees
          // the stage once it has read them.
          named_sync(2, kConsumers);
          if (p.dq != nullptr) {
            const uint32_t at =
                cQ + w * (L::QSTR / 2) + ((wq * 16 + g8) * kStgRow + 2 * t4) * 4;
#pragma unroll
            for (int tt = 0; tt < 16; ++tt) {
              st_shared(at + tt * 32, dq[4 * tt], dq[4 * tt + 1]);
              st_shared(at + 8 * kStgRow * 4 + tt * 32, dq[4 * tt + 2], dq[4 * tt + 3]);
            }
            if (t == 0) dq_meta[2 * stage + w] = make_int2(q0, h);
            fence_async_smem();
            mbar_arrive(&dq_full[2 * stage + w]);
          }
        } else if constexpr (DQ) {
          wgmma_wait<0>();
          fence_regs(dq);
          if (p.dq != nullptr) {
            // Stage each part for the writer warp in the next buffer of the
            // ring: a wait only when the ring is full.
#pragma unroll
            for (int c = 0; c < (D == 256 ? 2 : 1); ++c) {
              const int buf = n_stg % nstg;
              mbar_wait(&dq_empty[2 * w + buf], ((n_stg / nstg) & 1) ^ 1);
              const uint32_t at = stg0 + buf * dq_stg_bytes<D>(w) + stg_at;
#pragma unroll
              for (int tt = 0; tt < (D == 160 ? 12 : 8); ++tt) {
                if (D == 160 && w == 0 && tt >= 8) continue;
                st_shared(at + tt * 32, dq[32 * c + 4 * tt], dq[32 * c + 4 * tt + 1]);
                st_shared(at + 8 * dq_row<D>(w) * 4 + tt * 32, dq[32 * c + 4 * tt + 2],
                          dq[32 * c + 4 * tt + 3]);
              }
              if (t == 0) dq_meta[2 * w + buf] = make_int2(q0, h);
              fence_async_smem();
              mbar_arrive(&dq_full[2 * w + buf]);
              ++n_stg;
            }
          }
        }
        ++n_x;
      }
      if (L::STG && p.dq != nullptr) {  // end the writer's walk at the last record's stage
        if (t == 0) dq_meta[2 * (n % S) + w] = make_int2(-1, -1);
        mbar_arrive(&dq_full[2 * (n % S) + w]);
      } else if (DQ && p.dq != nullptr) {  // end the writer's walk
        const int buf = n_stg % nstg;
        mbar_wait(&dq_empty[2 * w + buf], ((n_stg / nstg) & 1) ^ 1);
        if (t == 0) dq_meta[2 * w + buf] = make_int2(-1, -1);
        mbar_arrive(&dq_full[2 * w + buf]);
      }
    } else {
      int n_dq = 0;   // steps with a dQ product: the dS buffer alternates with it
      int n_stg = 0;  // 64 x 64 dQ parts staged: the staging handshake's phase
      for (int n = 0;; ++n) {
        const int stage = n % S;
        mbar_wait(&full[stage], (n / S) & 1);
        const int4 step = sStep[stage];
        if (step.x < 0) break;
        const int h = hk * p.group + step.x, q0 = step.y * BM;
        const bool vis0 = step.z & kTake0, vis1 = step.z & kTake1;
        const bool masked = step.z & (w ? kMask1 : kMask0);
        const bool mine = w ? vis1 : vis0;  // uniform in the warpgroup
        const uint32_t cQ = sQ + stage * L::QT, cdO = sdO + stage * L::QT;
        const uint32_t cdS = sdS + (n_dq & 1) * L::BOX;
        // This thread's dS^T pair (row R, columns 8 tt + 2 t4, +1) of n-block
        // tt sits at ds_at ^ (tt << 4) in the 128-byte swizzle (R & 7 == g8);
        // row R + 8 is 1024 bytes on.
        const uint32_t ds_at = cdS + (w * 64 + wq * 16 + g8) * 128 + (g8 << 4) + t4 * 4;
        if (mine) {
          float s[32], dp[32];
          uint32_t pP[4][4], pS[4][4];  // bf16 P^T and dS^T: the A operands of dV and dK
          // S^T = K Q^T (line 11) and dP^T = V dO^T (line 13): 64 kv rows x 64
          // q columns, k over head_dim in the tiles' swizzled boxes.
          const auto kv_desc = [&](uint32_t base, int kk) {
            return sw128_desc(base + (kk >> 2) * L::BOX + rows_at + (kk & 3) * 32, 16);
          };
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64<0, 0>(s, kv_desc(sK, kk), kmajor_desc<D>(cQ, kk), kk > 0);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64<0, 0>(dp, kv_desc(sV, kk), kmajor_desc<D>(cdO, kk), kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);

          // P^T = exp2(S^T log2(e) - lse log2(e)); element i of n-block tt is
          // kv row kv_a (i < 2) or kv_b, q column q0 + 8 tt + 2 t4 + (i & 1).
          // A hidden element scores kHidden: P^T is exp(mask - lse), 1 on a row
          // that sees no key. The kv ids are read from shared memory here, at
          // row kv & (ROWS - 1) of the CTA's (k0 is a multiple of ROWS), so no
          // id and no address of them stays live through the step: with either,
          // ptxas serialised the fused SEG kernel's wgmma at 160.
          const float* cl = sLse + stage * BM;
          const float* cd = sDelta + stage * BM;
          const int* cq = sQid + stage * BM;
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            const int cc = tt * 8 + 2 * t4;
            const float2 l2 = *reinterpret_cast<const float2*>(cl + cc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float x = s[4 * tt + i];
              if (masked) {
                bool v = visible(p, q0 + cc + (i & 1) + p.q_offset, i < 2 ? kv_a : kv_b);
                if (SEG)
                  v = v && cq[cc + (i & 1)] == sKvid[(i < 2 ? kv_a : kv_b) & (L::ROWS - 1)];
                if (!v) x = kHidden;
              }
              s[4 * tt + i] = exp2f(fmaf(x, kLog2e, -((i & 1) ? l2.y : l2.x)));
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            pP[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
            pP[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pP[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pP[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
          }
          // dV += P^T dO (line 12): k over the tile's 64 q rows.
          wgmma_fence();
          wgmma_rs_k64<D>(dv, pP, cdO);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(dp);

          // dS^T = P^T o (dP^T - delta) (line 14), rounded to bf16.
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            const float2 d2 = *reinterpret_cast<const float2*>(cd + tt * 8 + 2 * t4);
#pragma unroll
            for (int i = 0; i < 4; ++i) dp[4 * tt + i] = s[4 * tt + i] * (dp[4 * tt + i] - ((i & 1) ? d2.y : d2.x));
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            pS[kk][0] = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
            pS[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
            pS[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
            pS[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
          }
          // dK += dS^T Q (line 16).
          wgmma_fence();
          wgmma_rs_k64<D>(dk, pS, cQ);
          wgmma_commit();
          if (DQ) {
#pragma unroll
            for (int tt = 0; tt < 8; ++tt) {
              st_shared(ds_at ^ (tt << 4), pS[tt >> 1][(tt & 1) * 2]);
              st_shared((ds_at ^ (tt << 4)) + 1024, pS[tt >> 1][(tt & 1) * 2 + 1]);
            }
          }
          wgmma_wait<0>();  // dV and dK: P^T and dS^T are free
          fence_regs(dv);
          fence_regs(dk);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(pP[kk]);
            fence_regs(pS[kk]);
          }
        }
        mbar_arrive(&empty[stage]);  // this stage's Q, dO, lse, delta and ids are read
        if (DQ && (vis0 || vis1)) {
          // dQ_i += dS K_j (line 15) over the pair's 128 kv rows: at D = 128
          // both warpgroups, each a half of head_dim (its 64-column box of
          // K); at D = 64 one warpgroup a step, in turn, the whole row. A
          // hidden tile's dS rows are zeros.
          if (!mine) {
#pragma unroll
            for (int tt = 0; tt < 8; ++tt) {
              st_shared(ds_at ^ (tt << 4), 0u);
              st_shared((ds_at ^ (tt << 4)) + 1024, 0u);
            }
          }
          fence_async_smem();
          if constexpr (D == 64) {
            // Warpgroup n_dq % 2 (broadcast from lane 0, so that ptxas sees
            // the branch uniform) computes the step's dQ; the other arrives
            // at the step's barrier and goes on to its next step. The
            // barriers alternate with the turns, so an arrival never meets
            // the other turn's phase. The buffer of dQ step m is written
            // again at step m + 2: by this warpgroup after its own product,
            // by the other after its wait at step m + 1, which this
            // warpgroup's arrival there ends.
            const int who = __shfl_sync(0xffffffffu, n_dq & 1, 0);
            if (who != w) {
              named_arrive(1 + who, kConsumers);
            } else {
              named_sync(1 + w, kConsumers);  // both tiles' dS are in the buffer
              float dq[32];
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 8; ++kk)
                wgmma_ss_n64<1, 1>(dq, sw128_desc(cdS + kk * 2048, 8192),
                                   sw128_desc(sK + kk * 2048, 8192), kk > 0);
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(dq);
              if (p.dq != nullptr) {
                // Stage it for the warpgroup's writer warp, which has had the
                // other warpgroup's turn to read the last one.
                mbar_wait(&dq_empty[w], (n_stg & 1) ^ 1);
                const uint32_t at = stg + ((wq * 16 + g8) * kDqRow + 2 * t4) * 4;
#pragma unroll
                for (int tt = 0; tt < 8; ++tt) {
                  st_shared(at + tt * 32, dq[4 * tt], dq[4 * tt + 1]);
                  st_shared(at + 8 * kDqRow * 4 + tt * 32, dq[4 * tt + 2], dq[4 * tt + 3]);
                }
                if (t == 0) dq_meta[w] = make_int2(q0, h);
                fence_async_smem();
                mbar_arrive(&dq_full[w]);
              }
              ++n_stg;
            }
          } else {
            named_sync(1, kConsumers);  // both tiles' dS are in the buffer
            float dq[32];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              wgmma_ss_n64<1, 1>(dq, sw128_desc(cdS + kk * 2048, 8192),
                                 sw128_desc(sK + w * 16384 + kk * 2048, 8192), kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dq);
            if (p.dq != nullptr) {
              // Stage this warpgroup's 64 x 64 f32 part for its writer warp.
              mbar_wait(&dq_empty[w], (n_stg & 1) ^ 1);
              const uint32_t at = stg + ((wq * 16 + g8) * kDqRow + 2 * t4) * 4;
#pragma unroll
              for (int tt = 0; tt < 8; ++tt) {
                st_shared(at + tt * 32, dq[4 * tt], dq[4 * tt + 1]);
                st_shared(at + 8 * kDqRow * 4 + tt * 32, dq[4 * tt + 2], dq[4 * tt + 3]);
              }
              if (t == 0) dq_meta[w] = make_int2(q0, h);
              fence_async_smem();
              mbar_arrive(&dq_full[w]);
            }
            ++n_stg;
          }
          ++n_dq;
        }
      }
      if (DQ && p.dq != nullptr) {  // end the writer's walk
        mbar_wait(&dq_empty[w], (n_stg & 1) ^ 1);
        if (t == 0) dq_meta[w] = make_int2(-1, -1);
        mbar_arrive(&dq_full[w]);
      }
    }

    // dK and dV of the tile, summed over the CTA's q heads: written once
    // (HALF: each warpgroup its columns; at 160 n-block tt of warpgroup 0
    // is box 0's for tt < 8, then the tail's; with hs shares a partial of
    // Hkv * hs heads, the CTA's at hk * hs + sp).
    if (w == 0 || has1 || HALF) {
      const long long rs = static_cast<long long>(p.Hkv) * hs * D;
      const long long base = static_cast<long long>(b) * p.Skv * rs + (hk * hs + sp) * D + 2 * t4;
      const int n_tt = D == 160 && w ? 8 : DC / 8;
#pragma unroll
      for (int tt = 0; tt < DC / 8; ++tt) {
        if (tt >= n_tt) continue;
        const int col = D == 160 ? (tt < 8 ? w * 64 + tt * 8 : 128 + (tt - 8) * 8)
                                 : (HALF ? w * DC : 0) + tt * 8;
        if (kv_a < p.Skv) {
          *reinterpret_cast<float2*>(p.dv + base + kv_a * rs + col) = make_float2(dv[4 * tt], dv[4 * tt + 1]);
          *reinterpret_cast<float2*>(p.dk + base + kv_a * rs + col) = make_float2(dk[4 * tt], dk[4 * tt + 1]);
        }
        if (kv_b < p.Skv) {
          *reinterpret_cast<float2*>(p.dv + base + kv_b * rs + col) = make_float2(dv[4 * tt + 2], dv[4 * tt + 3]);
          *reinterpret_cast<float2*>(p.dk + base + kv_b * rs + col) = make_float2(dk[4 * tt + 2], dk[4 * tt + 3]);
        }
      }
    }
  }
}

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kKvThreads, 1)
    fa2_bwd_fused_kernel(const BwdParams p, const __grid_constant__ BwdMaps maps) {
  kv_stationary<D, true, SEG, DENSE>(p, maps);
}

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kKvThreads, 1)
    fa2_bwd_dkv_kernel(const BwdParams p, const __grid_constant__ BwdMaps maps) {
  kv_stationary<D, false, SEG, DENSE>(p, maps);
}

// ------------------------------------------------------------- group sum

// fa2_bwd_group_sum_kernel replaces no TPU kernel. It is the second pass of
// the KV-stationary kernels at 160 and 256 where their grid splits a
// group's q heads over several CTAs (hsplit, chosen by the wrapper where a
// CTA a kv tile would leave the card short of work): each CTA wrote the dK
// and dV of its heads into f32 partials (B, Skv, Hkv * hsplit, D), and this
// pass adds each kv head's hsplit partials in a fixed order, 0 first, into
// dk and dv (B, Skv, Hkv, D): no atomics, so dK and dV stay bitwise the
// same from launch to launch. It reads the partials once and writes the
// sums once, so it is bound by HBM: 16-byte loads (streaming: the partials
// are dead after it) and stores, a thread a 4-float piece of an output row,
// the same piece of its hsplit partial rows (D * 4 bytes apart) summed in
// registers; blockIdx.y picks dK or dV. 32-bit indices (the entry refuses
// more than 2^31 pieces): a 64-bit division is a call ptxas gives a stack.
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads) fa2_bwd_group_sum_kernel(
    const float* part_k, const float* part_v, float* dk, float* dv, int n4, int d4,
    int hsplit) {
  const float4* part = reinterpret_cast<const float4*>(blockIdx.y ? part_v : part_k);
  float4* out = reinterpret_cast<float4*>(blockIdx.y ? dv : dk);
  for (int i = blockIdx.x * kSumThreads + threadIdx.x; i < n4; i += gridDim.x * kSumThreads) {
    const int r = i / d4;
    const float4* src = part + static_cast<long long>(r) * hsplit * d4 + (i - r * d4);
    float4 a = __ldcs(src);
    for (int x = 1; x < hsplit; ++x) {
      const float4 y = __ldcs(src + x * d4);
      a.x += y.x;
      a.y += y.y;
      a.z += y.z;
      a.w += y.w;
    }
    out[i] = a;
  }
}


// --------------------------------------------------------------------- dq

// Whether the dq kernel's grid puts batch * head on x, the q tile or pair
// on y (at 160 and 256: every head's longest walks in the first wave),
// rather than the pairs on x (kernels/flash_bwd.py dq_grid mirrors it).
__host__ __device__ constexpr bool dq_head_major(int D) { return D == 160 || D == 256; }

// Shared memory of the dq kernel at head_dim 64, 128 and 160 (dq_pair), in
// bytes from a 1024-aligned base: the pair's Q and dO tiles (each D / 64
// boxes of 64 rows x 64 columns; at 160 two 128-byte-swizzled boxes and a
// 64-byte-swizzled tail box of 32 columns), the K and V stages of the ring
// (4 stages, 3 at 160), each stage's kv ids (SEG) and step record, the two
// tiles' 128 staged lse and delta values, then the mbarriers. About 194 KB
// at D = 128, 202 KB at 160.
template <int D>
struct DqSmem {
  static constexpr int STAGES = D == 160 ? 3 : 4;
  static constexpr uint32_t TILE = kBlockM * D * 2;  // a 64-row tile: 16 KB at D = 128
  static constexpr uint32_t Q = 0, DO = 2 * TILE, K = 4 * TILE;
  static constexpr uint32_t V = K + STAGES * TILE;
  static constexpr uint32_t KID = V + STAGES * TILE;
  static constexpr uint32_t STEP = KID + STAGES * kBlockN * 4;
  static constexpr uint32_t LSE = STEP + STAGES * 8;
  static constexpr uint32_t DELTA = LSE + 2 * kBlockM * 4;
  static constexpr uint32_t BARS = DELTA + 2 * kBlockM * 4;  // full, empty, q
  static constexpr uint32_t BYTES = BARS + (2 * STAGES + 1) * 8;
};

// Stage the lse (times log2 e, with the fused kernel's kHidden rule for a
// row that sees no key, +inf past Sq) and delta of q rows i0 * 64 .. +
// rows - 1 of head row bh into shared memory: the producer warp's lanes.
__device__ __forceinline__ void stage_rows(const BwdParams& p, float* sLse, float* sDelta,
                                           int bh, int i0, int rows, int lane) {
  const long long row0 = static_cast<long long>(bh) * p.Sq;
  for (int r = lane; r < rows; r += 32) {
    const int qr = i0 * kBlockM + r;
    float l = INFINITY, d = 0.f;
    if (qr < p.Sq) {
      l = p.lse[row0 + qr];
      l = l == -INFINITY        ? 0.f
          : l < 0.5f * kMaskValue ? kHidden * kLog2e + (l - kMaskValue) * kLog2e
                                  : l * kLog2e;  // kHidden: a row that sees no key
      d = p.delta[row0 + qr];
    }
    sLse[r] = l;
    sDelta[r] = d;
  }
}

// The walk of a dq CTA (its q tiles i0 and, if has1, i0 + 1 of batch row
// b): the q-major table's slices (PairWalk with group 1, as the forward),
// or under DENSE every kv tile.
template <bool SKIP, bool DENSE>
__device__ __forceinline__ PairWalk<SKIP, DENSE> dq_walk(const BwdParams& p, int i0, bool has1,
                                                         int b) {
  PairWalk<SKIP, DENSE> walk;
  walk.group = 1;
  walk.n_tiles = (p.Skv + kBlockN - 1) / kBlockN;
  walk.g = 0;
  if (DENSE) {
    walk.steps = walk.bits = nullptr;
    walk.a0 = walk.a1 = walk.b0 = walk.b1 = 0;
  } else {
    walk.steps = p.table + p.t_q + 1;
    walk.bits = SKIP ? p.bits + static_cast<long long>(b) * p.n_vis : nullptr;
    walk.a0 = p.table[i0];
    walk.a1 = p.table[i0 + 1];
    walk.b0 = has1 ? p.table[i0 + 1] : 0;
    walk.b1 = has1 ? p.table[i0 + 2] : 0;
  }
  walk.ia = walk.a0;
  walk.ib = walk.b0;
  return walk;
}

// The record flags of the step at kv tile j (kTake0/1, kMask0/1): the
// table's flags and step bits (entries ea, eb of the walk), or under DENSE
// the classifier, with SEG on the owners' id ranges (q_lo, q_hi) and the
// kv tile's, which the producer warp's lanes copy into kid (64 ints) first.
// Only the element mask reads the kv ids: on the compact schedule they are
// copied by cp.async, when a tile needs it, onto `full`, whose phase then
// also waits for them. A row past Skv reads 0 there; the mask hides its
// column anyway (visible() is false past Skv).
template <bool SEG, bool DENSE>
__device__ __forceinline__ int dq_step_flags(const BwdParams& p, const int* walk_steps,
                                             const int* walk_bits, int ea, int eb, int j, int i0,
                                             bool has1, const int* kid_g, int* kid,
                                             const int (&q_lo)[2], const int (&q_hi)[2],
                                             uint64_t* full, int lane) {
  const int k0 = j * kBlockN;
  int flags = 0;
  if (DENSE) {
    int lo = 0x7fffffff, hi = -0x7fffffff;
    if (SEG) {
      for (int r = lane; r < kBlockN; r += 32) {
        const int id = k0 + r < p.Skv ? kid_g[k0 + r] : kKvPadSegment;
        kid[r] = id;
        lo = min(lo, id);
        hi = max(hi, id);
      }
      warp_range(lo, hi);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      TileClass c = classify_tile(p, (i0 + x) * kBlockM + p.q_offset, k0);
      if (SEG) c = with_ids(c, q_lo[x], q_hi[x], lo, hi);
      if ((x == 0 || has1) && !c.empty)
        flags |= (x ? kTake1 : kTake0) | (c.mask ? (x ? kMask1 : kMask0) : 0);
    }
  } else {
    if (ea >= 0)
      flags |= kTake0 | ((walk_steps[ea] & 1) || (SEG && !(walk_bits[ea] & kSegUniform))
                             ? kMask0 : 0);
    if (eb >= 0)
      flags |= kTake1 | ((walk_steps[eb] & 1) || (SEG && !(walk_bits[eb] & kSegUniform))
                             ? kMask1 : 0);
    if (SEG && (flags & (kMask0 | kMask1))) {
      for (int r = lane; r < kBlockN; r += 32) {
        const bool in = k0 + r < p.Skv;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(kid + r)),
                     "l"(kid_g + (in ? k0 + r : 0)), "r"(in ? 4 : 0)
                     : "memory");
      }
      asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(full))
                   : "memory");
    }
  }
  return flags;
}

// DENSE with SEG: the id range of each q tile the CTA owns (has1 is
// uniform in the warp, so warp_range's shuffles see every lane).
template <bool SEG, bool DENSE>
__device__ __forceinline__ void dq_owner_ranges(const BwdParams& p, int b, int i0, bool has1,
                                                int lane, int (&q_lo)[2], int (&q_hi)[2]) {
  q_lo[0] = q_lo[1] = q_hi[0] = q_hi[1] = 0;
  if (!(DENSE && SEG)) return;
  const int* qid_g = p.q_seg + b * p.q_seg_sb;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (x == 1 && !has1) continue;
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int r = (i0 + x) * kBlockM + lane; r < (i0 + x + 1) * kBlockM; r += 32) {
      const int id = r < p.Sq ? qid_g[r] : kQPadSegment;
      lo = min(lo, id);
      hi = max(hi, id);
    }
    warp_range(lo, hi);
    q_lo[x] = lo;
    q_hi[x] = hi;
  }
}

// The dq kernel at head_dim 64, 128 and 160: a CTA per pair of q tiles,
// each consumer warpgroup one tile at full width (the header's dq
// paragraph).
template <int D, bool SEG, bool DENSE>
__device__ __forceinline__ void dq_pair(const BwdParams& p, const BwdMaps& maps) {
  using L = DqSmem<D>;
  constexpr int kDqStages = L::STAGES;
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are dropped before their fetch
  constexpr int BM = kBlockM, BN = kBlockN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + kDqStages;
  uint64_t* q_bar = empty + kDqStages;
  int* sKid = reinterpret_cast<int*>(sm + L::KID);
  float* sLse = reinterpret_cast<float*>(sm + L::LSE);  // lse * log2(e), +inf past Sq
  float* sDelta = reinterpret_cast<float*>(sm + L::DELTA);
  // Per stage: (kv tile, step flags); a negative tile ends the walk. The
  // producer walks and classifies; the consumers read this.
  int2* sStep = reinterpret_cast<int2*>(sm + L::STEP);

  // Longest walks first (dq_head_major: every head's).
  constexpr bool HEAD_X = dq_head_major(D);
  const int i0 = 2 * ((p.t_q + 1) / 2 - 1 - static_cast<int>(HEAD_X ? blockIdx.y : blockIdx.x));
  const bool has1 = i0 + 1 < p.t_q;  // an odd t_q leaves the last pair one tile
  const int bh = HEAD_X ? blockIdx.x : blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes; TMA bytes on top
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_bar, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform (see rec)
  if (wg == 0) {
    // Producer: one warp. Q, dO, lse and delta once; then, per step of the
    // walk, K_j and V_j by TMA, the kv tile's ids (SEG) and the step's record.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(q_bar, (has1 ? 4 : 2) * L::TILE);
        for (int x = 0; x < (has1 ? 2 : 1); ++x) {
          load_tile<D>(sm + L::Q + x * L::TILE, maps.q, maps.q_tail, q_bar, h, (i0 + x) * BM, b);
          load_tile<D>(sm + L::DO + x * L::TILE, maps.dout, maps.dout_tail, q_bar, h,
                       (i0 + x) * BM, b);
        }
      }
      stage_rows(p, sLse, sDelta, bh, i0, 2 * BM, lane);
      mbar_arrive(q_bar);

      PairWalk<SKIP, DENSE> walk = dq_walk<SKIP, DENSE>(p, i0, has1, b);
      const int* kid_g = SEG ? p.kv_seg + b * p.kv_seg_sb : nullptr;
      int q_lo[2], q_hi[2];
      dq_owner_ranges<SEG, DENSE>(p, b, i0, has1, lane, q_lo, q_hi);
      int g, j, ea, eb;
      // (A `break` out of this loop crashes ptxas 12.9; the loop ends on `more`.)
      bool more = true;
      for (int n = 0; more; ++n) {
        more = walk.next(g, j, ea, eb);
        const int stage = n % kDqStages;
        mbar_wait(&empty[stage], ((n / kDqStages) & 1) ^ 1);
        if (!more) {  // the walk's end: a record with a negative tile, no copies
          if (lane == 0) sStep[stage] = make_int2(-1, 0);
          mbar_arrive(&full[stage]);
          continue;
        }
        const int k0 = j * BN;
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * L::TILE);
          load_tile<D>(sm + L::K + stage * L::TILE, maps.k, maps.k_tail, &full[stage], hk, k0, b);
          load_tile<D>(sm + L::V + stage * L::TILE, maps.v, maps.v_tail, &full[stage], hk, k0, b);
        }
        const int flags = dq_step_flags<SEG, DENSE>(p, walk.steps, walk.bits, ea, eb, j, i0, has1,
                                                    kid_g, sKid + stage * BN, q_lo, q_hi,
                                                    &full[stage], lane);
        if (lane == 0) sStep[stage] = make_int2(j, flags);
        mbar_arrive(&full[stage]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Consumer warpgroup w owns q tile i0 + w: rows q0 .. q0 + 63.
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int wq = t / 32, lane = t % 32, g8 = lane / 4, t4 = lane % 4;
    const int q0 = (i0 + w) * BM;
    const int r_a = wq * 16 + g8;  // this thread's rows of the tile: r_a, r_a + 8
    const int row_a = q0 + r_a, row_b = row_a + 8;
    int qid[2] = {0, 0};
    if (SEG) {
      const int* qid_g = p.q_seg + b * p.q_seg_sb;
      qid[0] = row_a < p.Sq ? qid_g[row_a] : kQPadSegment;
      qid[1] = row_b < p.Sq ? qid_g[row_b] : kQPadSegment;
    }
    const int take = w ? kTake1 : kTake0, needs_mask = w ? kMask1 : kMask0;
    const uint32_t sQ = smem_u32(sm + L::Q) + w * L::TILE;
    const uint32_t sdO = smem_u32(sm + L::DO) + w * L::TILE;
    const uint32_t sK = smem_u32(sm + L::K), sV = smem_u32(sm + L::V);

    // dQ of the tile: rows r_a / r_a + 8, columns 8 tt + 2 t4 (+1).
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    uint32_t pc[4][4];  // dS of the pending step: bf16 A fragments of dQ += dS K
    int pend = -1;      // the stage whose dQ += dS K is not issued yet

    mbar_wait(q_bar, 0);
    const float lse_r[2] = {sLse[w * BM + r_a], sLse[w * BM + r_a + 8]};
    const float delta_r[2] = {sDelta[w * BM + r_a], sDelta[w * BM + r_a + 8]};
    for (int n = 0;; ++n) {
      const int stage = n % kDqStages;
      mbar_wait(&full[stage], (n / kDqStages) & 1);
      // The record, broadcast from lane 0: ptxas then sees the branches
      // around the wgmmas as warp-uniform and does not serialise them.
      int2 rec = sStep[stage];
      rec.x = __shfl_sync(0xffffffffu, rec.x, 0);
      rec.y = __shfl_sync(0xffffffffu, rec.y, 0);
      if (rec.x < 0) break;
      if (!(rec.y & take)) {
        // Not this tile's step: finish the pending product, so that no stage
        // stays held while the producer waits for it, and release both.
        if (pend >= 0) {
          wgmma_fence();
          wgmma_rs_k64<D>(dq, pc, sK + pend * L::TILE);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
          mbar_arrive(&empty[pend]);
          pend = -1;
        }
        mbar_arrive(&empty[stage]);
        continue;
      }
      const int j = rec.x;
      const uint32_t cK = sK + stage * L::TILE, cV = sV + stage * L::TILE;

      // S = Q K^T (line 11) and dP = dO V^T (line 13), 64 x 64 over head_dim
      // in the tiles' swizzled boxes, issued together with the pending step's
      // dQ += dS K (line 15). The first step of a run has none pending: it
      // issues one with dS = 0 (dQ += 0 exactly), so the products and their
      // waits are the same on every taken step.
      const bool first = pend < 0;
      if (first)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[kk][e] = 0u;
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64<0, 0>(s, kmajor_desc<D>(sQ, kk), kmajor_desc<D>(cK, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64<0, 0>(dp, kmajor_desc<D>(sdO, kk), kmajor_desc<D>(cV, kk), kk > 0);
      wgmma_commit();
      wgmma_rs_k64<D>(dq, pc, sK + (first ? stage : pend) * L::TILE);
      wgmma_commit();
      wgmma_wait<2>();
      fence_regs(s);

      // P = exp2(S log2(e) - lse log2(e)); element i of n-block tt is row
      // row_a (i < 2) or row_b, kv column j * 64 + 8 tt + 2 t4 + (i & 1). A
      // hidden element scores kHidden: P is exp(mask - lse), 1 on a row that
      // sees no key.
      const bool masked = rec.y & needs_mask;
      const int* cKid = sKid + stage * BN;
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        const int cc = tt * 8 + 2 * t4;
        int2 kid = make_int2(0, 0);
        if (SEG && masked) kid = *reinterpret_cast<const int2*>(cKid + cc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[4 * tt + i];
          if (masked) {
            bool vis = visible(p, (i < 2 ? row_a : row_b) + p.q_offset, j * BN + cc + (i & 1));
            if (SEG) vis = vis && qid[i >> 1] == ((i & 1) ? kid.y : kid.x);
            if (!vis) x = kHidden;
          }
          s[4 * tt + i] = exp2f(fmaf(x, kLog2e, -lse_r[i >> 1]));
        }
      }
      wgmma_wait<1>();
      fence_regs(dp);
      // dS = P o (dP - delta) (line 14), rounded to bf16 as dS K's A operand.
      uint32_t pn[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;  // rows a, b, a, b; columns 16 kk + 2 t4 (+8)
          const float d = delta_r[e & 1];
          pn[kk][e] = pack_bf16(s[i] * (dp[i] - d), s[i + 1] * (dp[i + 1] - d));
        }
      }
      wgmma_wait<0>();  // the pending dQ += dS K is done: its stage is free
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
      if (!first) mbar_arrive(&empty[pend]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[kk][e] = pn[kk][e];
      pend = stage;
    }
    if (pend >= 0) {  // the last step's dQ += dS K
      wgmma_fence();
      wgmma_rs_k64<D>(dq, pc, sK + pend * L::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
      mbar_arrive(&empty[pend]);
    }

    // dQ of the tile, written once (zeros where the tile took no step).
    const long long rs = static_cast<long long>(p.Hq) * D;
    float* out = p.dq + static_cast<long long>(b) * p.Sq * rs + h * D + 2 * t4;
#pragma unroll
    for (int tt = 0; tt < D / 8; ++tt) {
      if (row_a < p.Sq)
        *reinterpret_cast<float2*>(out + row_a * rs + tt * 8) = make_float2(dq[4 * tt], dq[4 * tt + 1]);
      if (row_b < p.Sq)
        *reinterpret_cast<float2*>(out + row_b * rs + tt * 8) =
            make_float2(dq[4 * tt + 2], dq[4 * tt + 3]);
    }
  }
}

// Shared memory of the dq kernel at head_dim 256 (dq_wide), in bytes from
// a 1024-aligned base: the CTA's Q and dO tiles, the K ring (KST stages)
// and the V ring (VST stages), three 64 x 64 bf16 dS tiles (zeros, then
// the two slots the steps alternate between; 128-byte swizzled, the K-major
// A layout), per K stage the kv tile's ids (SEG) and the step record, the
// staged lse and delta, then the mbarriers: K full and empty, V full and
// empty, q. 64 + 96 + 32 + 24 KB + 1.3 KB = 217.3 KB. A CTA may use 227 KB
// (232,448 bytes) with the 1024 bytes of alignment.
struct DqWideSmem {
  static constexpr int D = 256;
  static constexpr int KST = 3;  // K stages
  static constexpr int VST = 1;  // V stages
  static constexpr int NDS = 3;  // dS tiles: zeros, slot 0, slot 1
  // setmaxnreg: a consumer thread holds 64 + 16 + 16 accumulators, so its
  // warpgroups take 232 registers and the producer's 40, where 24 made the
  // producer warp spill; 168 a thread at entry either way.
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS == 168 * 384, "the CTA's registers");
  static constexpr uint32_t TILE = kBlockM * D * 2;       // a 64-row tile of Q, dO, K or V
  static constexpr uint32_t DSB = kBlockM * kBlockN * 2;  // a dS tile: 8 KB
  static constexpr uint32_t Q = 0, DO = TILE, K = 2 * TILE;
  static constexpr uint32_t V = K + KST * TILE;
  static constexpr uint32_t DS = V + VST * TILE;
  static constexpr uint32_t KID = DS + NDS * DSB;
  static constexpr uint32_t STEP = KID + KST * kBlockN * 4;
  static constexpr uint32_t LSE = STEP + KST * 8;
  static constexpr uint32_t DELTA = LSE + kBlockM * 4;
  static constexpr uint32_t BARS = DELTA + kBlockM * 4;
  static constexpr uint32_t BYTES = BARS + (2 * KST + 2 * VST + 1) * 8;
  static_assert(BYTES + 1024 <= 232448, "a CTA may use 227 KB of shared memory");
};

// The dq kernel at head_dim 256 (the header's dq paragraph): a CTA per q
// tile, warpgroup w columns [128 w, 128 w + 128) of dQ and half of the
// step's kv columns of S and dP; K and V on their own rings; batch * head
// on the grid's x.
template <bool SEG, bool DENSE>
__device__ __forceinline__ void dq_wide(const BwdParams& p, const BwdMaps& maps) {
  using L = DqWideSmem;
  constexpr int D = L::D;
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are dropped before their fetch
  constexpr int DC = D / 2;             // columns of dQ a warpgroup holds
  constexpr int BM = kBlockM, BN = kBlockN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* k_empty = k_full + L::KST;
  uint64_t* v_full = k_empty + L::KST;
  uint64_t* v_empty = v_full + L::VST;
  uint64_t* q_bar = v_empty + L::VST;
  int* sKid = reinterpret_cast<int*>(sm + L::KID);
  float* sLse = reinterpret_cast<float*>(sm + L::LSE);  // lse * log2(e), +inf past Sq
  float* sDelta = reinterpret_cast<float*>(sm + L::DELTA);
  // Per K stage: (kv tile, step flags); a negative tile ends the walk.
  int2* sStep = reinterpret_cast<int2*>(sm + L::STEP);

  // Longest walks first (dq_head_major: every head's).
  constexpr bool HEAD_X = dq_head_major(D);
  const int i0 = p.t_q - 1 - static_cast<int>(HEAD_X ? blockIdx.y : blockIdx.x);
  const int bh = HEAD_X ? blockIdx.x : blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::KST; ++s) {
      mbar_init(&k_full[s], 32);  // the producer warp's lanes; TMA bytes on top
      mbar_init(&k_empty[s], kConsumers);
    }
    for (int s = 0; s < L::VST; ++s) {
      mbar_init(&v_full[s], 1);  // the producer's lane 0; TMA bytes on top
      mbar_init(&v_empty[s], kConsumers);
    }
    mbar_init(q_bar, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform (see rec)
  if (wg == 0) {
    // Producer: one warp. Q, dO, lse, delta and the zero dS tile once; then,
    // per step of the walk, K_j, the kv ids (SEG) and the step's record on
    // K's barrier, then V_j on V's.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS) : "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(q_bar, 2 * L::TILE);
        load_tile<D>(sm + L::Q, maps.q, maps.q_tail, q_bar, h, i0 * BM, b);
        load_tile<D>(sm + L::DO, maps.dout, maps.dout_tail, q_bar, h, i0 * BM, b);
      }
      stage_rows(p, sLse, sDelta, bh, i0, BM, lane);
      for (int i = lane; i < static_cast<int>(L::DSB / 16); i += 32)
        reinterpret_cast<uint4*>(sm + L::DS)[i] = make_uint4(0u, 0u, 0u, 0u);
      fence_async_smem();  // the zeros are read by wgmma
      mbar_arrive(q_bar);

      PairWalk<SKIP, DENSE> walk = dq_walk<SKIP, DENSE>(p, i0, false, b);
      const int* kid_g = SEG ? p.kv_seg + b * p.kv_seg_sb : nullptr;
      int q_lo[2], q_hi[2];
      dq_owner_ranges<SEG, DENSE>(p, b, i0, false, lane, q_lo, q_hi);
      int g, j, ea, eb;
      // (A `break` out of this loop crashes ptxas 12.9; the loop ends on `more`.)
      bool more = true;
      for (int n = 0; more; ++n) {
        more = walk.next(g, j, ea, eb);
        const int ks = n % L::KST;
        mbar_wait(&k_empty[ks], ((n / L::KST) & 1) ^ 1);
        if (!more) {  // the walk's end: a record with a negative tile, no copies
          if (lane == 0) sStep[ks] = make_int2(-1, 0);
          mbar_arrive(&k_full[ks]);
          continue;
        }
        if (lane == 0) {
          mbar_expect_tx(&k_full[ks], L::TILE);
          load_tile<D>(sm + L::K + ks * L::TILE, maps.k, maps.k_tail, &k_full[ks], hk, j * BN, b);
        }
        const int flags = dq_step_flags<SEG, DENSE>(p, walk.steps, walk.bits, ea, eb, j, i0, false,
                                                    kid_g, sKid + ks * BN, q_lo, q_hi,
                                                    &k_full[ks], lane);
        if (lane == 0) sStep[ks] = make_int2(j, flags);
        mbar_arrive(&k_full[ks]);
        const int vs = n % L::VST;
        mbar_wait(&v_empty[vs], ((n / L::VST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&v_full[vs], L::TILE);
          load_tile<D>(sm + L::V + vs * L::TILE, maps.v, maps.v_tail, &v_full[vs], hk, j * BN, b);
          mbar_arrive(&v_full[vs]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS) : "memory");
    // Both consumer warpgroups own q tile i0: rows q0 .. q0 + 63, w its
    // columns [128 w, 128 w + 128) of dQ.
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int wq = t / 32, lane = t % 32, g8 = lane / 4, t4 = lane % 4;
    const int q0 = i0 * BM;
    const int r_a = wq * 16 + g8;  // this thread's rows of the tile: r_a, r_a + 8
    const int row_a = q0 + r_a, row_b = row_a + 8;
    int qid[2] = {0, 0};
    if (SEG) {
      const int* qid_g = p.q_seg + b * p.q_seg_sb;
      qid[0] = row_a < p.Sq ? qid_g[row_a] : kQPadSegment;
      qid[1] = row_b < p.Sq ? qid_g[row_b] : kQPadSegment;
    }
    const int take = kTake0, needs_mask = kMask0;
    const uint32_t sQ = smem_u32(sm + L::Q), sdO = smem_u32(sm + L::DO);
    const uint32_t sK = smem_u32(sm + L::K), sV = smem_u32(sm + L::V);

    // dQ of the tile: rows r_a / r_a + 8, columns 8 tt + 2 t4 (+1) of the
    // warpgroup's half.
    float dq[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_bar, 0);
    const float lse_r[2] = {sLse[r_a], sLse[r_a + 8]};
    const float delta_r[2] = {sDelta[r_a], sDelta[r_a + 8]};
    // S and dP once a step: each warpgroup computes them for its 32 of the
    // step's 64 kv columns and writes its half of bf16 dS into the step's slot; after
    // the named barrier both add dS K into their columns of dQ, the
    // product issued with the next step's S and dP. This thread's dS
    // values sit in row r_a (and r_a + 8, 1024 bytes on) of the 64 x 64
    // slot, kv columns 32 w + 8 tt + 2 t4 (+1): 16-byte chunk 4 w + tt of
    // the 128-byte swizzled row, at x_at ^ (tt << 4).
    const uint32_t sDS = smem_u32(sm + L::DS);  // the zero tile; the slots follow
    const uint32_t x_at = r_a * 128 + ((g8 ^ (4 * w)) << 4) + t4 * 4;
    int pend = -1;  // the K stage whose dQ += dS K is not issued yet
    int n_x = 0;    // taken steps: the dS slot alternates with them
    for (int n = 0;; ++n) {
      const int ks = n % L::KST, vs = n % L::VST;
      mbar_wait(&k_full[ks], (n / L::KST) & 1);
      // The record, broadcast from lane 0: ptxas then sees the branches
      // around the wgmmas as warp-uniform and does not serialise them.
      int2 rec = sStep[ks];
      rec.x = __shfl_sync(0xffffffffu, rec.x, 0);
      rec.y = __shfl_sync(0xffffffffu, rec.y, 0);
      if (rec.x < 0) break;
      mbar_wait(&v_full[vs], (n / L::VST) & 1);  // every position's: parity waits skip none
      const uint32_t pdS = sDS + (1 + ((n_x & 1) ^ 1)) * L::DSB;  // the pending step's slot
      if (!(rec.y & take)) {
        // DENSE: the tile is empty there. Finish the pending product, so
        // that no stage stays held while the producer waits for it.
        if (pend >= 0) {
          wgmma_fence();
          wg_ss_k64<D, DC>(dq, pdS, sK + pend * L::TILE, w);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
          mbar_arrive(&k_empty[pend]);
          pend = -1;
        }
        mbar_arrive(&k_empty[ks]);
        mbar_arrive(&v_empty[vs]);
        continue;
      }
      const int j = rec.x;
      const uint32_t cK = sK + ks * L::TILE, cV = sV + vs * L::TILE;
      const uint32_t cdS = sDS + (1 + (n_x & 1)) * L::DSB;  // this step's slot

      // S = Q K^T (line 11) and dP = dO V^T (line 13) for the warpgroup's
      // 32 kv columns (K's and V's rows 32 w ..): n32 products over
      // head_dim, issued with the pending step's dQ += dS K (line 15), over
      // both halves of its dS; the first step of a run reads the zero tile
      // (dQ += 0 exactly), so every taken step issues the same products.
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32<0, 0>(s, kmajor_desc<D>(sQ, kk), kmajor_desc_half<D>(cK, kk, w), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32<0, 0>(dp, kmajor_desc<D>(sdO, kk), kmajor_desc_half<D>(cV, kk, w), kk > 0);
      wgmma_commit();
      wg_ss_k64<D, DC>(dq, pend < 0 ? sDS : pdS, sK + (pend < 0 ? ks : pend) * L::TILE, w);
      wgmma_commit();
      wgmma_wait<2>();
      fence_regs(s);

      // P = exp2(S log2(e) - lse log2(e)); element i of n-block tt is row
      // row_a (i < 2) or row_b, kv column j * 64 + cc + (i & 1). A hidden
      // element scores kHidden: P is exp(mask - lse), 1 on a row that sees
      // no key.
      const bool masked = rec.y & needs_mask;
      const int* cKid = sKid + ks * BN;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int cc = 32 * w + tt * 8 + 2 * t4;
        int2 kid = make_int2(0, 0);
        if (SEG && masked) kid = *reinterpret_cast<const int2*>(cKid + cc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[4 * tt + i];
          if (masked) {
            bool vis = visible(p, (i < 2 ? row_a : row_b) + p.q_offset, j * BN + cc + (i & 1));
            if (SEG) vis = vis && qid[i >> 1] == ((i & 1) ? kid.y : kid.x);
            if (!vis) x = kHidden;
          }
          s[4 * tt + i] = exp2f(fmaf(x, kLog2e, -lse_r[i >> 1]));
        }
      }
      wgmma_wait<1>();
      fence_regs(dp);
      mbar_arrive(&v_empty[vs]);  // dP has read V_j
      // dS = P o (dP - delta) (line 14), rounded to bf16 into the slot.
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[4 * tt + i] = s[4 * tt + i] * (dp[4 * tt + i] - delta_r[i >> 1]);
        st_shared(cdS + (x_at ^ (tt << 4)), pack_bf16(dp[4 * tt], dp[4 * tt + 1]));
        st_shared(cdS + (x_at ^ (tt << 4)) + 1024, pack_bf16(dp[4 * tt + 2], dp[4 * tt + 3]));
      }
      wgmma_wait<0>();  // the pending dQ += dS K is done: its K stage is free
      fence_regs(dq);
      if (pend >= 0) mbar_arrive(&k_empty[pend]);
      fence_async_smem();
      // Both halves of this step's dS are in its slot, and both
      // warpgroups' pending products are done: the slot they read is
      // written again only after the next step's barrier.
      named_sync(1, kConsumers);
      pend = ks;
      ++n_x;
    }
    if (pend >= 0) {  // the last step's dQ += dS K
      wgmma_fence();
      wg_ss_k64<D, DC>(dq, sDS + (1 + ((n_x & 1) ^ 1)) * L::DSB, sK + pend * L::TILE, w);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(&k_empty[pend]);
    }

    // dQ of the tile, written once (zeros where the tile took no step), each
    // warpgroup its half of the columns.
    const long long rs = static_cast<long long>(p.Hq) * D;
    float* out = p.dq + static_cast<long long>(b) * p.Sq * rs + h * D + w * DC + 2 * t4;
#pragma unroll
    for (int tt = 0; tt < DC / 8; ++tt) {
      if (row_a < p.Sq)
        *reinterpret_cast<float2*>(out + row_a * rs + tt * 8) = make_float2(dq[4 * tt], dq[4 * tt + 1]);
      if (row_b < p.Sq)
        *reinterpret_cast<float2*>(out + row_b * rs + tt * 8) =
            make_float2(dq[4 * tt + 2], dq[4 * tt + 3]);
    }
  }
}

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kKvThreads, 1)
    fa2_bwd_dq_kernel(const BwdParams p, const __grid_constant__ BwdMaps maps) {
  static_assert(D == 64 || D == 128 || D == 160 || D == 256,
                "the dq kernel takes head_dim 64, 128, 160 or 256");
  if constexpr (D == 256)
    dq_wide<SEG, DENSE>(p, maps);
  else
    dq_pair<D, SEG, DENSE>(p, maps);
}

// Fill the fields every backward kernel reads (all but dq, dk, dv, t_q, t_kv).
BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* table, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                     long long d_sb, long long d_ss, long long d_sh, int Hq, int Hkv, int Sq,
                     int Skv, int causal, int window, int sink, int q_offset, const void* q_seg,
                     const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
                     const void* bits, int n_vis) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.table = static_cast<const int*>(table);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.d_sb = d_sb; p.d_ss = d_ss; p.d_sh = d_sh;
  p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv; p.Sq = Sq; p.Skv = Skv;
  p.t_kv = p.t_q = 0;
  p.causal = causal; p.window = window; p.sink = sink; p.q_offset = q_offset;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.bits = static_cast<const int*>(bits);
  p.q_seg_sb = q_seg_sb; p.kv_seg_sb = kv_seg_sb; p.n_vis = n_vis;
  p.hgroup = p.group;
  return p;
}

// Whether an entry's arguments are consistent: segments are on with q ids;
// the compact schedule reads a table (with segments, step bits too, which
// may be null where no step is visible: n_vis 0, and no walk reads them),
// the dense one neither.
bool schedule_args_ok(const BwdParams& p, int dense) {
  if (dense) return p.table == nullptr && p.bits == nullptr;
  return p.table != nullptr && (p.q_seg == nullptr || p.bits != nullptr || p.n_vis == 0);
}

// Whether the KV-stationary kernels take a split of the group's q heads
// into hsplit shares: whole shares, and more than one only at 160 and 256.
bool head_split_ok(int hsplit, int group, int head_dim) {
  return hsplit >= 1 && group % hsplit == 0 &&
         (hsplit == 1 || head_dim == 160 || head_dim == 256);
}


bool make_maps(BwdMaps* maps, const BwdParams& p, int batch, int D, int kv_rows) {
  const auto four = [&](int cols, CUtensorMap* q, CUtensorMap* dout, CUtensorMap* k,
                        CUtensorMap* v) {
    return make_map(q, p.q, batch, p.Sq, p.Hq, D, p.q_sb, p.q_ss, p.q_sh, kBlockM, cols) &&
           make_map(dout, p.dout, batch, p.Sq, p.Hq, D, p.d_sb, p.d_ss, p.d_sh, kBlockM, cols) &&
           make_map(k, p.k, batch, p.Skv, p.Hkv, D, p.k_sb, p.k_ss, p.k_sh, kv_rows, cols) &&
           make_map(v, p.v, batch, p.Skv, p.Hkv, D, p.v_sb, p.v_ss, p.v_sh, kv_rows, cols);
  };
  return four(64, &maps->q, &maps->dout, &maps->k, &maps->v) &&
         (D % 64 == 0 ||  // the tail boxes of head_dim 160
          four(32, &maps->q_tail, &maps->dout_tail, &maps->k_tail, &maps->v_tail));
}

// The KV-stationary kernels (fused: DQ) of one (D, SEG, DENSE): one CTA
// per (pair of kv tiles, or one at 160 and 256, batch * kv head * share of
// the group's q heads).
template <int D, bool DQ, bool SEG, bool DENSE>
cudaError_t launch_kv(const BwdParams& p, int batch, int t_kv, void* stream) {
  BwdMaps maps;
  if (!make_maps(&maps, p, batch, D, kv_rows<D>())) return cudaErrorInvalidValue;
  auto kernel = DQ ? fa2_bwd_fused_kernel<D, SEG, DENSE> : fa2_bwd_dkv_kernel<D, SEG, DENSE>;
  const size_t smem = KvSmem<D, DQ, DENSE>::BYTES + 1024;  // + the alignment of the base
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int ctas = kv_rows<D>() == kBlockN ? t_kv : (t_kv + 1) / 2;  // a tile (160, 256) or a pair
  const dim3 grid = kv_rows<D>() == kBlockN ? dim3(batch * p.Hkv, p.group / p.hgroup, ctas)
                                            : dim3(batch * p.Hkv, ctas);
  kernel<<<grid, kKvThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p, maps);
  return cudaGetLastError();
}


template <int D, bool DQ>
cudaError_t dispatch_kv(const BwdParams& p, int batch, int t_kv, bool seg, bool dense,
                        void* stream) {
  if (dense)
    return seg ? launch_kv<D, DQ, true, true>(p, batch, t_kv, stream)
               : launch_kv<D, DQ, false, true>(p, batch, t_kv, stream);
  return seg ? launch_kv<D, DQ, true, false>(p, batch, t_kv, stream)
             : launch_kv<D, DQ, false, false>(p, batch, t_kv, stream);
}

template <bool DQ>
cudaError_t dispatch_kv_by_dim(const BwdParams& p, int batch, int t_kv, int head_dim, bool seg,
                               bool dense, void* stream) {
  return head_dim == 64    ? dispatch_kv<64, DQ>(p, batch, t_kv, seg, dense, stream)
         : head_dim == 128 ? dispatch_kv<128, DQ>(p, batch, t_kv, seg, dense, stream)
         : head_dim == 160 ? dispatch_kv<160, DQ>(p, batch, t_kv, seg, dense, stream)
         : head_dim == 256 ? dispatch_kv<256, DQ>(p, batch, t_kv, seg, dense, stream)
                           : cudaErrorInvalidValue;
}

// The dq kernel of one (D, SEG, DENSE): one CTA per (pair of q tiles, or
// one at 256, batch * q head). At 160 and 256 batch * head is the grid's x,
// so that the first wave holds every head's longest causal walks; at 64
// and 128 the pairs are (dq_head_major; kernels/flash_bwd.py dq_grid).
template <int D, bool SEG, bool DENSE>
cudaError_t launch_dq(const BwdParams& p, int batch, void* stream) {
  BwdMaps maps;
  if (!make_maps(&maps, p, batch, D, kBlockN)) return cudaErrorInvalidValue;
  auto kernel = fa2_bwd_dq_kernel<D, SEG, DENSE>;
  size_t smem;  // + the 1024-byte alignment of the base
  if constexpr (D == 256)
    smem = DqWideSmem::BYTES + 1024;
  else
    smem = DqSmem<D>::BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int ctas = D == 256 ? p.t_q : (p.t_q + 1) / 2;  // one q tile a CTA at 256, else a pair
  const dim3 grid = dq_head_major(D) ? dim3(batch * p.Hq, ctas) : dim3(ctas, batch * p.Hq);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kKvThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, maps);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dq(const BwdParams& p, int batch, bool seg, bool dense, void* stream) {
  if (dense)
    return seg ? launch_dq<D, true, true>(p, batch, stream)
               : launch_dq<D, false, true>(p, batch, stream);
  return seg ? launch_dq<D, true, false>(p, batch, stream)
             : launch_dq<D, false, false>(p, batch, stream);
}

// The head dims and tiles the backward kernels are instantiated for (every
// head dim in every mode: compact and dense, without and with segments).
bool kernel_shape_ok(int head_dim, int block_q, int block_kv) {
  return (head_dim == 64 || head_dim == 128 || head_dim == 160 || head_dim == 256) &&
         block_q == kBlockM && block_kv == kBlockN;
}

}  // namespace

extern "C" int fa2_bwd_delta_bf16(const void* o, const void* dout, void* delta, long long o_sb,
                                  long long o_ss, long long o_sh, long long d_sb, long long d_ss,
                                  long long d_sh, int batch, int Hq, int Sq, int head_dim,
                                  void* stream) {
  DeltaParams p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.delta = static_cast<float*>(delta);
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.d_sb = d_sb; p.d_ss = d_ss; p.d_sh = d_sh;
  p.Hq = Hq; p.Sq = Sq;
  // R positions a CTA: 8 (whole 32-byte sectors of delta's runs), doubled
  // while a CTA holds fewer than 256 rows and the grid still fills the
  // card's 132 SMs once.
  int R = 8;
  while (R * Hq < 256 && batch * ((Sq + 2 * R - 1) / (2 * R)) >= 132) R *= 2;
  p.R = R;
  const dim3 grid((Sq + R - 1) / R, batch);
  const size_t smem = static_cast<size_t>(R) * Hq * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    fa2_bwd_delta_kernel<64><<<grid, kDeltaThreads, smem, s>>>(p);
  else if (head_dim == 128)
    fa2_bwd_delta_kernel<128><<<grid, kDeltaThreads, smem, s>>>(p);
  else if (head_dim == 160)
    fa2_bwd_delta_kernel<160><<<grid, kDeltaThreads, smem, s>>>(p);
  else if (head_dim == 256)
    fa2_bwd_delta_kernel<256><<<grid, kDeltaThreads, smem, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The entries below take the instantiations the training paths need
// (head_dim 128: qwen3; 64: whisper and the gpt presets; 64 x 64 tiles),
// without and with segments (null q ids: none), on the compact schedule
// (table, step bits) or the dense one (dense != 0: neither); the same at
// head_dims 160 (stablelm) and 256 (gemma3).

extern "C" int fa2_bwd_fused_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* dk,
                                  void* dv, const void* table, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, long long d_sb,
                                  long long d_ss, long long d_sh, int batch, int Hq, int Hkv,
                                  int Sq, int Skv, int head_dim, int block_q, int block_kv,
                                  int causal, int window, int sink, int q_offset, int t_kv,
                                  int dense, int hsplit, const void* q_seg, const void* kv_seg,
                                  long long q_seg_sb, long long kv_seg_sb, const void* bits,
                                  int n_vis, void* stream) {
  if (!kernel_shape_ok(head_dim, block_q, block_kv)) return cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, table, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, d_sb, d_ss, d_sh, Hq, Hkv, Sq, Skv, causal, window,
                           sink, q_offset, q_seg, kv_seg, q_seg_sb, kv_seg_sb, bits,
                           n_vis);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.t_kv = t_kv;
  if (!schedule_args_ok(p, dense) || !head_split_ok(hsplit, p.group, head_dim))
    return cudaErrorInvalidValue;
  p.hgroup = p.group / hsplit;
  return dispatch_kv_by_dim<true>(p, batch, t_kv, head_dim, q_seg != nullptr, dense != 0,
                                  stream);
}

extern "C" int fa2_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const void* table, long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, long long d_sb, long long d_ss,
                                long long d_sh, int batch, int Hq, int Hkv, int Sq, int Skv,
                                int head_dim, int block_q, int block_kv, int causal, int window,
                                int sink, int q_offset, int t_kv, int dense, int hsplit,
                                const void* q_seg, const void* kv_seg, long long q_seg_sb,
                                long long kv_seg_sb, const void* bits, int n_vis, void* stream) {
  if (!kernel_shape_ok(head_dim, block_q, block_kv)) return cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, table, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, d_sb, d_ss, d_sh, Hq, Hkv, Sq, Skv, causal, window,
                           sink, q_offset, q_seg, kv_seg, q_seg_sb, kv_seg_sb, bits,
                           n_vis);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.t_kv = t_kv;
  if (!schedule_args_ok(p, dense) || !head_split_ok(hsplit, p.group, head_dim))
    return cudaErrorInvalidValue;
  p.hgroup = p.group / hsplit;
  return dispatch_kv_by_dim<false>(p, batch, t_kv, head_dim, q_seg != nullptr, dense != 0,
                                   stream);
}

extern "C" int fa2_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, const void* table,
                               long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                               long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, long long d_sb, long long d_ss, long long d_sh,
                               int batch, int Hq, int Hkv, int Sq, int Skv, int head_dim,
                               int block_q, int block_kv, int causal, int window, int sink,
                               int q_offset, int t_q, int dense, const void* q_seg,
                               const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
                               const void* bits, int n_vis, void* stream) {
  if (!kernel_shape_ok(head_dim, block_q, block_kv)) return cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, table, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, d_sb, d_ss, d_sh, Hq, Hkv, Sq, Skv, causal, window,
                           sink, q_offset, q_seg, kv_seg, q_seg_sb, kv_seg_sb, bits,
                           n_vis);
  p.dq = static_cast<float*>(dq);
  p.t_q = t_q;
  if (t_q < 1 || !schedule_args_ok(p, dense)) return cudaErrorInvalidValue;
  const bool seg = q_seg != nullptr;
  return head_dim == 64    ? dispatch_dq<64>(p, batch, seg, dense != 0, stream)
         : head_dim == 128 ? dispatch_dq<128>(p, batch, seg, dense != 0, stream)
         : head_dim == 160 ? dispatch_dq<160>(p, batch, seg, dense != 0, stream)
         : head_dim == 256 ? dispatch_dq<256>(p, batch, seg, dense != 0, stream)
                           : cudaErrorInvalidValue;
}

// dk, dv (rows x head_dim f32) = the sums of part_k, part_v (rows x hsplit x
// head_dim f32, contiguous) over their hsplit partials, in order.
extern "C" int fa2_bwd_group_sum_f32(const void* part_k, const void* part_v, void* dk, void* dv,
                                     long long rows, int hsplit, int head_dim, void* stream) {
  const int d4 = head_dim / 4;
  const long long n4 = rows * d4;
  if (hsplit < 1 || head_dim % 4 != 0 || rows < 0 || n4 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (n4 == 0) return cudaSuccess;
  // Enough CTAs for 8 a streaming multiprocessor, each over whole strides.
  const long long blocks = (n4 + kSumThreads - 1) / kSumThreads;
  const dim3 grid(static_cast<unsigned>(blocks < 132 * 8 ? blocks : 132 * 8), 2);
  fa2_bwd_group_sum_kernel<<<grid, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_k), static_cast<const float*>(part_v),
      static_cast<float*>(dk), static_cast<float*>(dv), static_cast<int>(n4), d4, hsplit);
  return cudaGetLastError();
}
