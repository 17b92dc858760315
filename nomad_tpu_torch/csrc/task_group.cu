// B9 (the K-step scan of solve_task_group_fused) and B10
// (score_nodes_once) as C entry points, both over B8 (score.cuh, shared
// with task_group_shard.cu and bulk_scan.cu).
//
// Replaces: score_nodes (nomad_tpu/tensor/kernels.py:113-249), the scan of
// solve_task_group with its tie_perm gather (kernels.py:267-378) behind the
// packed entry solve_task_group_fused (kernels.py:448-473), and
// score_nodes_once (kernels.py:630-663). The plain torch versions are
// score_nodes_ref / solve_task_group_fused_ref / score_nodes_once_ref in
// tensor/kernels.py; both read the packed f32 layout of pack_solve_args:
//
//   node_mat (N, 2D+6): avail[D] | used[D] | placed_tg | placed_job |
//                       feasible | affinity | dev_affinity | tie_perm
//   step_mat (K, 2): penalty_idx | active
//   spread_node (2S, N): val_id rows, then val_ok rows
//   spread_tab (2S, V): counts rows, then desired rows (NaN = no target)
//   spread_meta (S, 2): has_targets | weight
//   dp_node (2P, N): val_id rows, then val_ok rows
//   dp_tab (P, Vd+1): counts columns | limit column
//   scalars (5+D): lowest_boost | tg_count | dh_job | dh_tg | spread_alg |
//                  ask[D]
//
// One step scores every node with B8 (score.cuh, which states its formula).
// B9 repeats that K times in tie-permuted node space: the first maximal
// permuted position wins, and the carry (usage, placement counts, spread
// and distinct_property value counts, the lowest explicit boost) moves
// only where a node was found and the step is active.
//
// Bound on the H100: neither bytes nor operations. One launch moves
// ~N x 4 x (2D+6+2S+2P) bytes in and 12 K bytes out (under 1 MB at the
// cfg3 width, a fraction of a microsecond of HBM time); the work it needs
// is one full score a node, then per step the S x V and P x Vd value
// tables, the chosen node's rescore and, per node, a lookup per spread
// and property, an add and a division (a few microseconds at the 32-bit
// peak). The time goes to the K steps running one after another, each a
// pass over the nodes, a block-wide argmax and a carry update behind
// barriers.
//
// Design (B9): the cached identity of score.cuh, one CTA of 1024 threads.
// It gathers the columns into permuted order in a global scratch buffer
// (column-major; usage and placement counts are the carry), computes each
// position's cached terms (node_terms: the only powf outside the rescored
// nodes) and keeps those of the live ones, in position order, in shared
// memory (a node that is not ok_local never becomes so again: its usage
// and placements only grow), or in the scratch where they do not fit
// (kShared false: the same algorithm). A live node takes 4 bytes of head,
// 2 of meta, 2 a spread and 2 a property value id, and 4 of position. At
// most one spread and no distinct_property (the spread path's shape) pack
// meta and the value id into one 32-bit word (kLean, lean_score: 0.7 ms of
// 2.6 at cfg3 on the H100 against the general cache's three loads and
// runtime tree).
// The CTA also holds the count tables, the inverse permutation and a tile
// of the next steps' penalty slots. A step: 31 warps make one pass over
// the live slots, cached_score at each (score_node at the penalty slot),
// while the last warp moves the last winner's columns and rescores it; the
// (score desc, position asc) argmax by warp shuffles and one shared-memory
// round; then warp 0 alone updates the count tables and the lowest
// explicit boost and rebuilds the value tables (the whole block where they
// exceed 256 entries). Two __syncthreads a step. (A thread-block cluster
// splitting the positions was measured slower at every size, 2 to 8 CTAs:
// its exchange costs more than the pass it splits.) B10 runs score_node
// over the unpermuted layout, one thread a node.
//
// Wide shapes (D > 8, S > 8 or P > 8; score.cuh's dims_wide) take a
// second instance of each kernel, chosen by the entry points from the
// shape and compiled in wide/task_group.cu: score.cuh's wide
// helpers (no array sized by D, S or P; the spread tree by carry_tree),
// the winner's value ids in shared memory after the count tables rather
// than in the warps' reduction words, the compaction's ids moved sixteen
// a thread at a time, and more spread rows than warps in the value
// tables. The only shape either refuses is one whose count tables (and
// the wide ids) exceed a block's shared memory.
//
// Arithmetic: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn and accurate powf,
// built with --fmad=false and no fast math, so scores and choices equal
// the plain torch version on the card bit for bit.

#include "task_group.cuh"

extern "C" int nt_score_nodes(const void* node_mat, const void* spread_node,
                              const void* spread_tab, const void* spread_meta,
                              const void* dp_node, const void* dp_tab,
                              const void* scalars, void* out, int pen, int n,
                              int d, int s, int v, int p, int vd,
                              void* stream) {
  const Dims dm{n, d, s, v, p, vd};
  if (!dims_ok(dm) || table_bytes(dm) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dims_wide(dm)
                   ? nt_task_group::score_nodes_wide(
                         node_mat, spread_node, spread_tab, spread_meta,
                         dp_node, dp_tab, scalars, out, pen, dm, st)
                   : launch_score_nodes<false>(
                         node_mat, spread_node, spread_tab, spread_meta,
                         dp_node, dp_tab, scalars, out, pen, dm, st));
}

// f32 words of nt_solve_task_group's scratch at these sizes
extern "C" long long nt_solve_task_group_scratch_words(int n, int d, int s,
                                                       int v, int p,
                                                       int vd) {
  return scratch_need(Dims{n, d, s, v, p, vd});
}

// scratch: nt_solve_task_group_scratch_words(n, d, s, v, p, vd) f32 words,
// scratch_words their count (a smaller buffer is refused)
extern "C" int nt_solve_task_group(const void* node_mat, const void* step_mat,
                                   const void* spread_node,
                                   const void* spread_tab,
                                   const void* spread_meta,
                                   const void* dp_node, const void* dp_tab,
                                   const void* scalars, void* scratch,
                                   void* out, int n, int d, int k, int s,
                                   int v, int p, int vd, int scratch_words,
                                   void* stream) {
  const Dims dm{n, d, s, v, p, vd};
  if (!dims_ok(dm) || k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  if (scratch_need(dm) > (long long)scratch_words ||
      scan_smem(dm, false) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dims_wide(dm)
                   ? nt_task_group::solve_task_group_wide(
                         node_mat, step_mat, spread_node, spread_tab,
                         spread_meta, dp_node, dp_tab, scalars, scratch, out,
                         k, dm, st)
                   : launch_solve_task_group<false>(
                         node_mat, step_mat, spread_node, spread_tab,
                         spread_meta, dp_node, dp_tab, scalars, scratch, out,
                         k, dm, st));
}
