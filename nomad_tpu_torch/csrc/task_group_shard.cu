// B16, the per-eval scan with its node rows sharded: one host call and one
// cooperative launch a card a solve, every step inside it.
//
// Replaces: solve_task_group_sharded (nomad_tpu/tensor/sharding.py:107-122):
// B9, solve_task_group (kernels.py:267-378), run by XLA over node-sharded
// inputs, a global argmax each step. The plain torch version is
// solve_task_group_sharded_ref in tensor/sharding.py.
//
// Layout: shard s of S holds the canonical rows [s * n, (s + 1) * n) of the
// padded arrays in B9's packed layout (task_group.cu), except that
// node_mat's last column is each row's position in the tie-break order
// (the inverse of tie_perm), not tie_perm; step_mat, spread_tab,
// spread_meta, dp_tab and scalars are the same on every shard (each
// card's copy is read). A shard's spread_node and dp_node columns lie in
// rows `stride` long: the wrapper packs the whole mesh's arguments once a
// card and passes each shard pointers into them. Keeping the canonical
// rows (the reference's P("nodes")) and keying the argmax on (score desc,
// position asc) gives B9's choice: B9 takes the first maximal position of
// the permuted order, and a step that finds nothing still reports
// position 0, the node tie_perm[0].
//
// One CTA a shard (a mesh has at most 64 shards, fewer than a card's SMs),
// each with B9's design over its own rows (score.cuh's cached identity):
// at the start it copies its rows into a column-major scratch
// (ScratchNodes, canonical order, the global row in the "orig" column),
// computes each row's cached terms (node_terms) and
// keeps those of the live rows (ok_local; dead rows never come back), with
// each one's local row and tie-break position, in shared memory (or in the
// shard's scratch where they do not fit, kShared false), and the lowest
// position of all its rows. Every CTA holds the value tables (the counts,
// the boost of each spread value, the below-limit flag of each
// distinct_property value, the lowest explicit boost): they are the same
// on every CTA, which computes them from the same gathered candidates.
// A step:
//   - the pass: 31 warps score the shard's live slots with cached_score
//     (lean_score: one word a slot, where S <= 1 and P = 0; score_node at
//     the step's penalty slot), while the last warp stores the shard's
//     last winner's new columns and terms; the best by (score desc,
//     position asc);
//   - the push: warp 0 writes the shard's candidate (score bits | position
//     | global row | its slot | the spread, then distinct_property, value
//     ids, two to a word, kNoValue where the row lacks one or its ok flag
//     is off) into row s of every shard's gather buffer at the step's
//     parity, through a peer pointer where that shard lies on another
//     card; a shard with no live slot above NEG pushes (NEG, its lowest
//     position, that row), so a step that finds nothing reports position
//     0. Meanwhile the last warp computes what the candidate's commit
//     would store (its columns after the placement and node_terms of them,
//     B9's rescore): the same whenever it is computed, so the owner alone
//     refreshes a node's terms and the step's critical path holds no powf;
//   - one barrier of all CTAs (mesh.cuh's group_arrive_wait, by warp 0
//     alone: the other warps wait for the step's end), then warp 0 of each
//     CTA reads the S candidates (load_cg, one round: lane q reads row q)
//     and takes the same winner. It writes the step's output column (shard
//     0's CTA), lowers the lowest boost from this step's table, and
//     rebuilds the value tables with the winner's ids added to the counts
//     (the winner's row lives on one shard only: the counts move by the
//     candidate's own ids); the owner marks the winner's slot (the
//     candidate carries it) for the next pass.
// The gather buffers are double-buffered by parity, so one barrier a step
// suffices: a CTA writes step t + 2's row only after every CTA passed
// barrier t + 1, which each reaches after reading step t's rows. Across
// cards the launch starts and ends on a barrier of all its CTAs: no CTA
// stores into a card's buffers before that card's launch began, and no
// launch ends while another may still store into its buffers.
//
// Bound on the H100: the same work as B9, neither bytes nor operations (the
// bound of chip_smoke.py's scan_bound is under a microsecond). The time
// goes to the K steps one after another, each a pass over a shard's live
// slots, two block reductions and one barrier of the mesh's CTAs.
//
// Wide shapes (D > 8, S > 8 or P > 8; score.cuh's dims_wide) take a
// second instance, chosen by the entry point from the shape and compiled
// in wide/task_group_shard.cu: score.cuh's wide helpers, the
// commit's usage row (D f32) and the winner's ids (S + P u16) in shared
// memory after the value tables, the candidate's id words pushed and the
// winner's read a lane each in turn (a candidate row may be wider than a
// warp), and B9's wide compaction. Its only refusal is the shared memory
// of the count tables and those rows.
//
// Arithmetic: score.cuh's correctly rounded operations, built with
// --fmad=false and no fast math, and B9's commit order, so choices, founds
// and scores equal B9's (nt_solve_task_group) bit for bit.

#include "task_group_shard.cuh"

// int32 words of each shard's scratch at these sizes (n: a shard's rows)
extern "C" long long nt_task_group_shard_solve_scratch_words(
    int n, int d, int s, int v, int p, int vd, int shards) {
  return shard_layout(Dims{n, d, s, v, p, vd}, shards).words;
}

// B16: K placements of one task group over a node-sharded mesh, one
// cooperative launch a card. Arrays of S (by shard): node_mat, step_mat,
// spread_node, spread_tab, spread_meta, dp_node, dp_tab and scalars (each
// shard's pack, on its card: node_mat its n rows, spread_node and dp_node
// its n columns of rows `stride` long; the replicated ones read from each
// card's first shard) and scratch (nt_task_group_shard_solve_scratch_words
// each);
// out (3, K) f32 and the barrier words on shard 0's card. shard_card: each
// shard's place among the ``cards`` distinct cards, ordinals theirs. A
// card holds one CTA an SM (1024 threads), so a card with more shards than
// SMs returns cudaErrorCooperativeLaunchTooLarge (at most kMaxShards, 64,
// shards: never on an H100, 132 SMs).
extern "C" int nt_task_group_shard_solve(
    const void* const* node_mat, const void* const* step_mat,
    const void* const* spread_node, const void* const* spread_tab,
    const void* const* spread_meta, const void* const* dp_node,
    const void* const* dp_tab, const void* const* scalars,
    void* const* scratch, void* out, void* barrier, const int* shard_card,
    const int* ordinals, int cards, int shards, int k, int n, int d, int s,
    int v, int p, int vd, int stride, void* const* streams) {
  static std::mutex launching;
  const std::lock_guard<std::mutex> hold(launching);
  const Dims dm{n, d, s, v, p, vd};
  if (!dims_ok(dm) || k < 1 || shards < 1 || shards > kMaxShards ||
      cards < 1 || cards > nt_mesh::kMaxCards || cards > shards ||
      stride < n)
    return (int)cudaErrorInvalidValue;
  int count[nt_mesh::kMaxCards] = {0};
  for (int c = 0; c < cards; ++c) {
    if (ordinals[c] < 0 || ordinals[c] >= nt_mesh::kMaxCards)
      return (int)cudaErrorInvalidValue;
  }
  for (int q = 0; q < shards; ++q) {
    if (shard_card[q] < 0 || shard_card[q] >= cards)
      return (int)cudaErrorInvalidValue;
    ++count[shard_card[q]];
  }
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (cards > 1) err = nt_mesh::enable_peers(ordinals, cards);
  // every card holds its CTAs at once (one an SM), or none is launched
  for (int c = 0; c < cards && err == cudaSuccess; ++c) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 ordinals[c]);
    if (err == cudaSuccess && count[c] > sms)
      err = cudaErrorCooperativeLaunchTooLarge;
  }
  if (err != cudaSuccess) {
    cudaSetDevice(caller);
    return (int)err;
  }
  // the regions in shared memory where they fit
  const size_t base = base_bytes(dm) + wide_bytes(dm);
  const size_t region = 4 * (size_t)region_words(dm);
  const bool in_smem = base + region <= kMaxSmem;
  const size_t smem = base + (in_smem ? region : 0);
  if (smem > kMaxSmem) {
    cudaSetDevice(caller);
    return (int)cudaErrorInvalidValue;
  }
  const bool lean = s <= 1 && p == 0;
  const void* kernel = dims_wide(dm)
                           ? nt_task_group_shard::wide_kernel(in_smem, lean)
                           : shard_kernel<false>(in_smem, lean);
  TgArgs args{};
  for (int q = 0; q < shards; ++q) {
    args.node_mat[q] = (const float*)node_mat[q];
    args.spread_node[q] = (const float*)spread_node[q];
    args.dp_node[q] = (const float*)dp_node[q];
    args.scratch[q] = (int*)scratch[q];
  }
  args.out = (float*)out;
  args.barrier = (unsigned*)barrier;
  args.lay = shard_layout(dm, shards);
  args.dm = dm;
  args.k = k;
  args.shards = shards;
  args.stride = stride;
  args.cross = cards > 1;
  args.group_ctas = shards;
  for (int c = 0; c < cards && err == cudaSuccess; ++c) {
    int nc = 0, first = -1;
    for (int q = 0; q < shards; ++q) {
      if (shard_card[q] == c) {
        if (first < 0) first = q;
        args.card_shards[nc++] = q;
      }
    }
    args.step_mat = (const float*)step_mat[first];
    args.spread_tab = (const float*)spread_tab[first];
    args.spread_meta = (const float*)spread_meta[first];
    args.dp_tab = (const float*)dp_tab[first];
    args.scalars = (const float*)scalars[first];
    err = cudaSetDevice(ordinals[c]);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) break;
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel(kernel,
                                      dim3(nc),
                                      dim3(kThreads), params, smem,
                                      (cudaStream_t)streams[c]);
  }
  const cudaError_t back = cudaSetDevice(caller);
  if (err == cudaSuccess) err = back;
  return (int)err;
}
