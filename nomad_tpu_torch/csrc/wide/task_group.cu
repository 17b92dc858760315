// B9's and B10's wide instances (csrc/task_group.cu states the design):
// past 8 resource columns, spreads or distinct_property constraints. A
// translation unit of its own, compiled beside task_group.cu and linked
// into the same library, so that the build's time is not the two sets of
// instances one after another.

#include "../task_group.cuh"

namespace nt_task_group {

cudaError_t score_nodes_wide(const void* node_mat, const void* spread_node,
                             const void* spread_tab, const void* spread_meta,
                             const void* dp_node, const void* dp_tab,
                             const void* scalars, void* out, int pen,
                             const Dims& dm, cudaStream_t stream) {
  return launch_score_nodes<true>(node_mat, spread_node, spread_tab,
                                  spread_meta, dp_node, dp_tab, scalars, out,
                                  pen, dm, stream);
}

cudaError_t solve_task_group_wide(
    const void* node_mat, const void* step_mat, const void* spread_node,
    const void* spread_tab, const void* spread_meta, const void* dp_node,
    const void* dp_tab, const void* scalars, void* scratch, void* out, int k,
    const Dims& dm, cudaStream_t stream) {
  return launch_solve_task_group<true>(node_mat, step_mat, spread_node,
                                       spread_tab, spread_meta, dp_node,
                                       dp_tab, scalars, scratch, out, k, dm,
                                       stream);
}

}  // namespace nt_task_group
