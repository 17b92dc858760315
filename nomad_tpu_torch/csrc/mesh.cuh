// The node mesh's device-side barrier, shared by sharded.cu (B13, B14 and
// the barrier probe) and task_group_shard.cu (B16), and the host's peer
// access set-up of a mesh that spans cards.
//
// A group barrier over P participant CTAs, which may lie on several cards.
// Its two words (an arrival count, then a generation) live in device
// memory that every participant can reach: on one card plain device
// memory, across cards memory of one card reached by the others through
// peer access. Thread 0 of a CTA arrives and waits for the whole CTA:
//
//   __syncthreads(); fence; g0 = gen; if (count.fetch_add(1) == P - 1)
//   { count = 0; gen += 1 (release) } else spin until gen != g0
//   (acquire); fence; __syncthreads()
//
// as cooperative groups' grid sync does, with cuda::atomic_ref at device
// scope on one card and at system scope across cards (and the fence to
// match). The last arriver puts the count back to 0 before it moves the
// generation on, so the words need no reset between barriers or between
// launches: they are zeroed once, when they are made. (A reset queued on
// one card's stream could land while a CTA of the previous launch on
// another card still waits to see the last generation move.)
//
// The spin is bounded: past kBarrierTimeoutNs of %globaltimer the waiting
// CTA executes __trap(), so a barrier that can never complete (a missing
// participant, a card whose launch never started) ends the launch with an
// error that the next synchronisation raises, instead of a hang.
//
// Data a CTA pushes to other CTAs before a barrier is read after it with
// ld.global.cg (L2, not the CTA's own L1), see load_cg.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nt_mesh {

// a wait this long means a participant will never come
constexpr long long kBarrierTimeoutNs = 4000000000LL;
// the words of one group, a 128-byte line of their own
constexpr int kGroupWords = 32;
// card ordinals a mesh may name
constexpr int kMaxCards = 64;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <cuda::thread_scope Scope>
__device__ __forceinline__ void group_arrive_wait(unsigned* words,
                                                  int participants,
                                                  long long timeout_ns) {
  cuda::atomic_ref<unsigned, Scope> count(words[0]);
  cuda::atomic_ref<unsigned, Scope> gen(words[1]);
  if (Scope == cuda::thread_scope_system) {
    __threadfence_system();
  } else {
    __threadfence();
  }
  const unsigned g0 = gen.load(cuda::std::memory_order_acquire);
  if (count.fetch_add(1u, cuda::std::memory_order_acq_rel) ==
      (unsigned)participants - 1u) {
    count.store(0u, cuda::std::memory_order_relaxed);
    gen.fetch_add(1u, cuda::std::memory_order_release);
  } else {
    const long long t0 = global_ns();
    while (gen.load(cuda::std::memory_order_acquire) == g0) {
      if (global_ns() - t0 > timeout_ns) __trap();
      __nanosleep(32);
    }
  }
  if (Scope == cuda::thread_scope_system) {
    __threadfence_system();
  } else {
    __threadfence();
  }
}

// every thread of the CTA calls it; ``system``: the group spans cards
__device__ __forceinline__ void group_sync(unsigned* words, int participants,
                                           bool system,
                                           long long timeout_ns =
                                               kBarrierTimeoutNs) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (system) {
      group_arrive_wait<cuda::thread_scope_system>(words, participants,
                                                   timeout_ns);
    } else {
      group_arrive_wait<cuda::thread_scope_device>(words, participants,
                                                   timeout_ns);
    }
  }
  __syncthreads();
}

// peer access from every card of the mesh to every other (host side),
// enabled once per ordered pair; a pair without peer access refuses the
// launch
inline cudaError_t enable_peers(const int* ordinals, int cards) {
  static unsigned char done[kMaxCards][kMaxCards];
  for (int i = 0; i < cards; ++i) {
    for (int j = 0; j < cards; ++j) {
      const int a = ordinals[i], b = ordinals[j];
      if (a == b || done[a][b]) continue;
      cudaError_t err = cudaSetDevice(a);
      if (err != cudaSuccess) return err;
      int ok = 0;
      err = cudaDeviceCanAccessPeer(&ok, a, b);
      if (err != cudaSuccess) return err;
      if (!ok) return cudaErrorPeerAccessUnsupported;
      err = cudaDeviceEnablePeerAccess(b, 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // torch's copies may have enabled it
      } else if (err != cudaSuccess) {
        return err;
      }
      done[a][b] = 1;
    }
  }
  return cudaSuccess;
}

// a load of data another CTA (or card) wrote before a barrier
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  return __ldcg(p);
}

}  // namespace nt_mesh
