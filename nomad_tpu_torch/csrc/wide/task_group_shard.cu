// B16's wide instances (csrc/task_group_shard.cu states the design):
// past 8 resource columns, spreads or distinct_property constraints. A
// translation unit of its own, compiled beside task_group_shard.cu and
// linked into the same library, so that the build's time is not the two
// sets of instances one after another.

#include "../task_group_shard.cuh"

namespace nt_task_group_shard {

const void* wide_kernel(bool in_smem, bool lean) {
  return shard_kernel<true>(in_smem, lean);
}

}  // namespace nt_task_group_shard
