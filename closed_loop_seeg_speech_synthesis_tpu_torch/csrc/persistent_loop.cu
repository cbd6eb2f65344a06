// Persistent online loop, sm_90a: one graph launch decodes a whole
// closed-loop session.
//   Replaces the device side of closed_loop_seeg_speech_synthesis_tpu/
//   runtime/online.py PersistentOnlineDecoder (_build_loop: a
//   lax.while_loop whose body pulls a packet through an ordered io_callback,
//   runs the online step, keeps the carry unless the packet was data, and
//   emits the outputs through a second io_callback).
//
// The graph.  An outer graph holds one conditional WHILE node.  Its body is
//   wait_packet_kernel -> the captured online step (a child graph node: the
//     cudaGraph_t that torch.cuda.CUDAGraph recorded, which also masks the
//     carry commit with is_data and copies the outputs into static buffers)
//   -> publish_kernel, which sets the loop's condition.
// A session is one cudaGraphLaunch of it on a non-blocking stream; the
// loop runs until it has taken a STOP packet or the host sets the abort word.
//
// The two I/O edges are rings in mapped pinned host memory (cudaHostAlloc
// with cudaHostAllocMapped), R slots each:
//   packet slot: u64 sequence, u32 flag (STOP 0, DATA 1), pad, then the
//     packet (packet_size, n_channels) in the decoder's dtype;
//   output slot: u64 done sequence, u32 is_data, pad, then the step's output
//     segments (spec, spec_valid, audio, audio_valid) at the offsets the
//     caller gives.
// Sequences start at 1 and run on across sessions.  The host writes packet n
// into slot (n-1) % R, data first and the sequence word last (x86 keeps
// stores in order; the ring is not write-combined); the device acquires the
// sequence word at system scope before it reads the data.  The device writes
// the outputs, fences at system scope, then releases the done word.  The host
// writes packet n only after it has read output n - R (loop_wait_free), so
// no slot is overwritten before it was read.
//
// What bounds it on an H100: latency.  Each iteration moves one packet over
// PCIe (16 KB at 128 ch and 32 f32 samples) and ~2 KB of outputs back; the
// wait kernel's first thread spins on one word with __nanosleep, and one CTA
// of 256 threads copies the packet in 16-byte reads.  What remains per
// packet is the step's own ~200 kernels, now launched by the graph instead of
// the host.
//
// Every host entry point returns a cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <chrono>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SEG = 4;
constexpr unsigned FLAG_DATA = 1;
constexpr unsigned long long HDR = 16;  // bytes before a slot's payload

struct Control {                   // mapped host memory
  unsigned long long abort;        // host: nonzero ends the loop at its next wait
  unsigned long long taken;        // device: packets the loop has taken
  unsigned long long iterations;   // device: iterations published
  unsigned long long consumed;     // host: outputs the host has read
};

struct Desc {                      // the kernels' one parameter
  unsigned char* pkt_ring;         // device view of the packet ring
  unsigned long long pkt_stride, pkt_bytes;
  unsigned char* out_ring;         // device view of the output ring
  unsigned long long out_stride;
  unsigned long long R;
  Control* ctl;                    // device view of the control block
  unsigned char* packet;           // the captured step's static input
  int* is_data;                    // the captured step's static flag
  unsigned long long* cur;         // device scratch: sequence taken this iteration, 0 if none
  int n_seg;
  const unsigned char* seg_src[MAX_SEG];
  unsigned long long seg_bytes[MAX_SEG], seg_off[MAX_SEG];
  cudaGraphConditionalHandle handle;
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Waits for the next packet (or the abort word), then copies it into the
// step's static input and writes is_data.
__global__ void __launch_bounds__(THREADS) wait_packet_kernel(Desc d) {
  __shared__ int go;
  __shared__ const unsigned char* slot;
  if (threadIdx.x == 0) {
    const unsigned long long want = ld_acquire_sys(&d.ctl->taken) + 1;
    const unsigned char* s = d.pkt_ring + ((want - 1) % d.R) * d.pkt_stride;
    const unsigned long long* seq = reinterpret_cast<const unsigned long long*>(s);
    int ok = 0;
    unsigned ns = 32;
    for (;;) {
      if (ld_acquire_sys(seq) == want) {
        ok = 1;
        break;
      }
      if (ld_acquire_sys(&d.ctl->abort)) break;
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
    go = ok;
    slot = s;
    *d.cur = ok ? want : 0ull;
    *d.is_data = ok && __ldcv(reinterpret_cast<const unsigned*>(s + 8)) == FLAG_DATA;
    if (ok) st_release_sys(&d.ctl->taken, want);
  }
  __syncthreads();
  if (!go) return;  // aborted: the step runs on a stale packet, is_data = 0 keeps the carry
  const unsigned char* src = slot + HDR;
  const unsigned long long n16 = d.pkt_bytes / 16;
  for (unsigned long long i = threadIdx.x; i < n16; i += THREADS)
    reinterpret_cast<uint4*>(d.packet)[i] = __ldcv(reinterpret_cast<const uint4*>(src) + i);
  for (unsigned long long i = n16 * 4 + threadIdx.x; i < d.pkt_bytes / 4; i += THREADS)
    reinterpret_cast<unsigned*>(d.packet)[i] = __ldcv(reinterpret_cast<const unsigned*>(src) + i);
}

// Copies the step's static outputs into the output slot, releases its done
// word, and continues the loop while the packet was data and no abort came.
__global__ void __launch_bounds__(THREADS) publish_kernel(Desc d) {
  const unsigned long long seq = *d.cur;
  if (seq == 0) {
    if (threadIdx.x == 0) cudaGraphSetConditional(d.handle, 0);
    return;
  }
  unsigned char* slot = d.out_ring + ((seq - 1) % d.R) * d.out_stride;
  for (int s = 0; s < d.n_seg; ++s) {
    const unsigned char* src = d.seg_src[s];
    unsigned char* dst = slot + d.seg_off[s];
    for (unsigned long long i = threadIdx.x; i < d.seg_bytes[s]; i += THREADS) dst[i] = src[i];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int data = *d.is_data;
    *reinterpret_cast<volatile unsigned*>(slot + 8) = (unsigned)data;
    __threadfence_system();
    st_release_sys(reinterpret_cast<unsigned long long*>(slot), seq);
    st_release_sys(&d.ctl->iterations, ld_acquire_sys(&d.ctl->iterations) + 1);
    cudaGraphSetConditional(d.handle, data && !ld_acquire_sys(&d.ctl->abort) ? 1u : 0u);
  }
}

struct Loop {
  Desc d;
  int device;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaStream_t stream = nullptr;
  cudaEvent_t ready = nullptr;
  unsigned char* pkt_host = nullptr;
  unsigned char* out_host = nullptr;
  Control* ctl = nullptr;
  unsigned long long* cur = nullptr;
};

inline unsigned long long load_acquire(const unsigned long long* p) {
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}

inline void store_release(unsigned long long* p, unsigned long long v) {
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
}

inline void cpu_relax() {
#if defined(__x86_64__)
  __builtin_ia32_pause();
#endif
}

// Spins until ready() (0), the abort word is set (2) or timeout_s passes (1).
template <class F>
int spin(const Loop* L, double timeout_s, F ready) {
  const auto t0 = std::chrono::steady_clock::now();
  for (unsigned k = 0;; ++k) {
    if (ready()) return 0;
    if (load_acquire(&L->ctl->abort)) return ready() ? 0 : 2;
    if ((k & 255) == 0 &&
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count() > timeout_s)
      return 1;
    cpu_relax();
  }
}

const char* node_type_name(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal: return "semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "semaphore wait";
    case cudaGraphNodeTypeMemAlloc: return "memory alloc";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "other";
  }
}

void destroy(Loop* L) {
  if (L->exec) cudaGraphExecDestroy(L->exec);
  if (L->graph) cudaGraphDestroy(L->graph);
  if (L->ready) cudaEventDestroy(L->ready);
  if (L->stream) cudaStreamDestroy(L->stream);
  if (L->pkt_host) cudaFreeHost(L->pkt_host);
  if (L->out_host) cudaFreeHost(L->out_host);
  if (L->ctl) cudaFreeHost(L->ctl);
  if (L->cur) cudaFree(L->cur);
  delete L;
}

}  // namespace

// Writes into buf what the graph holds: its nodes by type, and how many of
// its kernel nodes launch thread-block clusters.  Named in the error when
// the loop cannot be built around the graph.
extern "C" int loop_describe_graph(const void* graph, char* buf, int size) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n ? n : 1];
  if ((err = cudaGraphGetNodes(g, nodes, &n)) != cudaSuccess) {
    delete[] nodes;
    return (int)err;
  }
  int count[32] = {0}, clustered = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(nodes[i], &t) != cudaSuccess) continue;
    count[(int)t & 31]++;
    if (t == cudaGraphNodeTypeKernel) {
      cudaLaunchAttributeValue v = {};
      if (cudaGraphKernelNodeGetAttribute(nodes[i], cudaLaunchAttributeClusterDimension, &v) ==
              cudaSuccess &&
          v.clusterDim.x * v.clusterDim.y * v.clusterDim.z > 1)
        ++clustered;
    }
  }
  delete[] nodes;
  cudaGetLastError();
  int off = snprintf(buf, size, "%zu nodes:", n);
  for (int t = 0; t < 32 && off < size; ++t)
    if (count[t])
      off += snprintf(buf + off, size - off, " %d %s", count[t],
                      node_type_name((cudaGraphNodeType)t));
  if (off < size) snprintf(buf + off, size - off, "; %d kernel node(s) launch clusters", clustered);
  return 0;
}

extern "C" const char* loop_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Builds the rings and the outer graph around step_graph (a cudaGraph_t,
// cloned into the loop's body) and instantiates it.  packet / is_data /
// seg_src are the step's static device buffers; seg_off are the output
// segments' offsets in an output slot of out_stride bytes.  On failure,
// *where names the call that failed.
extern "C" int loop_create(int device, const void* step_graph, void* packet,
                           unsigned long long pkt_bytes, int* is_data, int n_seg,
                           const void* const* seg_src, const unsigned long long* seg_bytes,
                           const unsigned long long* seg_off, unsigned long long out_stride,
                           int ring, void** out_loop, const char** where) {
  *out_loop = nullptr;
  if (n_seg < 1 || n_seg > MAX_SEG || ring < 1) {
    *where = "loop_create arguments";
    return (int)cudaErrorInvalidValue;
  }
  Loop* L = new Loop();
  L->device = device;
  Desc& d = L->d;
  d.R = (unsigned long long)ring;
  d.pkt_bytes = pkt_bytes;
  d.pkt_stride = HDR + (pkt_bytes + 15) / 16 * 16;
  d.out_stride = out_stride;
  d.packet = (unsigned char*)packet;
  d.is_data = is_data;
  d.n_seg = n_seg;
  for (int s = 0; s < n_seg; ++s) {
    d.seg_src[s] = (const unsigned char*)seg_src[s];
    d.seg_bytes[s] = seg_bytes[s];
    d.seg_off[s] = seg_off[s];
  }
  cudaError_t err;
#define TRY(call)             \
  if ((err = (call)) != cudaSuccess) { \
    *where = #call;           \
    destroy(L);               \
    return (int)err;          \
  }
  TRY(cudaSetDevice(device));
  TRY(cudaHostAlloc((void**)&L->pkt_host, d.R * d.pkt_stride, cudaHostAllocMapped));
  TRY(cudaHostAlloc((void**)&L->out_host, d.R * d.out_stride, cudaHostAllocMapped));
  TRY(cudaHostAlloc((void**)&L->ctl, sizeof(Control), cudaHostAllocMapped));
  memset(L->pkt_host, 0, d.R * d.pkt_stride);
  memset(L->out_host, 0, d.R * d.out_stride);
  memset(L->ctl, 0, sizeof(Control));
  TRY(cudaHostGetDevicePointer((void**)&d.pkt_ring, L->pkt_host, 0));
  TRY(cudaHostGetDevicePointer((void**)&d.out_ring, L->out_host, 0));
  TRY(cudaHostGetDevicePointer((void**)&d.ctl, L->ctl, 0));
  TRY(cudaMalloc((void**)&L->cur, sizeof(unsigned long long)));
  d.cur = L->cur;
  TRY(cudaStreamCreateWithFlags(&L->stream, cudaStreamNonBlocking));
  TRY(cudaEventCreateWithFlags(&L->ready, cudaEventDisableTiming));

  TRY(cudaGraphCreate(&L->graph, 0));
  TRY(cudaGraphConditionalHandleCreate(&d.handle, L->graph, 1, cudaGraphCondAssignDefault));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = d.handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop_node;
  TRY(cudaGraphAddNode(&loop_node, L->graph, nullptr, 0, &cp));
  cudaGraph_t body = cp.conditional.phGraph_out[0];

  void* args[] = {&d};
  cudaKernelNodeParams kp = {};
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(THREADS);
  kp.kernelParams = args;
  cudaGraphNode_t wait_node, step_node, publish_node;
  kp.func = (void*)wait_packet_kernel;
  TRY(cudaGraphAddKernelNode(&wait_node, body, nullptr, 0, &kp));
  TRY(cudaGraphAddChildGraphNode(&step_node, body, &wait_node, 1, (cudaGraph_t)step_graph));
  kp.func = (void*)publish_kernel;
  TRY(cudaGraphAddKernelNode(&publish_node, body, &step_node, 1, &kp));
  TRY(cudaGraphInstantiate(&L->exec, L->graph, 0));
#undef TRY
  *out_loop = L;
  *where = "";
  return 0;
}

// Host views of the output ring and the control block.
extern "C" int loop_host_views(void* h, void** out, void** ctl) {
  Loop* L = (Loop*)h;
  *out = L->out_host;
  *ctl = L->ctl;
  return 0;
}

// One session: the graph, launched on the loop's stream after the work
// queued so far on after_stream (the stream that wrote the static buffers).
extern "C" int loop_launch(void* h, void* after_stream) {
  Loop* L = (Loop*)h;
  cudaError_t err;
  if ((err = cudaSetDevice(L->device)) != cudaSuccess) return (int)err;
  if ((err = cudaEventRecord(L->ready, (cudaStream_t)after_stream)) != cudaSuccess) return (int)err;
  if ((err = cudaStreamWaitEvent(L->stream, L->ready, 0)) != cudaSuccess) return (int)err;
  if ((err = cudaGraphLaunch(L->exec, L->stream)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Waits until the session's graph has ended, on the loop's stream only.
extern "C" int loop_sync(void* h) { return (int)cudaStreamSynchronize(((Loop*)h)->stream); }

// Writes packet seq (flag STOP 0 / DATA 1) into its slot: data, flag, then
// the sequence word with release order.
extern "C" int loop_publish(void* h, unsigned long long seq, int flag, const void* data) {
  Loop* L = (Loop*)h;
  unsigned char* s = L->pkt_host + ((seq - 1) % L->d.R) * L->d.pkt_stride;
  memcpy(s + HDR, data, L->d.pkt_bytes);
  __atomic_store_n(reinterpret_cast<unsigned*>(s + 8), (unsigned)flag, __ATOMIC_RELAXED);
  store_release(reinterpret_cast<unsigned long long*>(s), seq);
  return 0;
}

// 0 when output seq is in its slot, 1 after timeout_s, 2 when aborted.
extern "C" int loop_wait_done(void* h, unsigned long long seq, double timeout_s) {
  const Loop* L = (const Loop*)h;
  const unsigned long long* done = reinterpret_cast<const unsigned long long*>(
      L->out_host + ((seq - 1) % L->d.R) * L->d.out_stride);
  return spin(L, timeout_s, [&] { return load_acquire(done) == seq; });
}

// 0 when packet seq's slot is free (the host has read output seq - R),
// 1 after timeout_s, 2 when aborted.
extern "C" int loop_wait_free(void* h, unsigned long long seq, double timeout_s) {
  const Loop* L = (const Loop*)h;
  return spin(L, timeout_s, [&] { return load_acquire(&L->ctl->consumed) + L->d.R >= seq; });
}

// The host has read output seq.
extern "C" int loop_release(void* h, unsigned long long seq) {
  store_release(&((Loop*)h)->ctl->consumed, seq);
  return 0;
}

extern "C" int loop_abort(void* h) {
  store_release(&((Loop*)h)->ctl->abort, 1);
  return 0;
}

// After an aborted session has ended (loop_sync): clears every slot's
// sequence word, marks what the loop took as read and clears the abort
// word, so the next session starts at packet taken + 1.  Returns taken.
extern "C" unsigned long long loop_recover(void* h) {
  Loop* L = (Loop*)h;
  for (unsigned long long r = 0; r < L->d.R; ++r) {
    store_release(reinterpret_cast<unsigned long long*>(L->pkt_host + r * L->d.pkt_stride), 0);
    store_release(reinterpret_cast<unsigned long long*>(L->out_host + r * L->d.out_stride), 0);
  }
  const unsigned long long taken = load_acquire(&L->ctl->taken);
  store_release(&L->ctl->consumed, taken);
  store_release(&L->ctl->abort, 0);
  return taken;
}

// Ends any running session (the abort word) and frees the loop.
extern "C" int loop_destroy(void* h) {
  Loop* L = (Loop*)h;
  store_release(&L->ctl->abort, 1);
  cudaError_t err = cudaStreamSynchronize(L->stream);
  destroy(L);
  return (int)err;
}
