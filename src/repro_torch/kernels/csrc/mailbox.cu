// Device mailboxes for rank processes that share one card
// (repro_torch.dist.ranks.Mailbox).
//
// Replaces no TPU kernel. The JAX package's shards exchange blocks and
// partial sums by device collectives (all_to_all, ppermute, psum) on the
// mesh's devices; the port runs a shard as a process, and processes on one
// card cannot use NCCL (it refuses two ranks on one device). So each rank
// holds one buffer of device memory that its peers map: it is allocated
// here with cudaMalloc, outside PyTorch's caching allocator (which would
// share a whole cached block and count references for tensors sent through
// queues), exported by CUDA IPC handle and opened in each peer. A plain C
// interface, loaded with ctypes; no kernel: the copies and sums into and
// out of a mailbox are PyTorch's own on the rank's stream, ordered across
// processes by IPC events. Every function returns the cudaError_t.

#include <cuda_runtime.h>

#include <cstring>

extern "C" {

int mailbox_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

int mailbox_alloc(size_t nbytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, nbytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, nbytes);
  return (int)err;
}

int mailbox_free(void* ptr) { return (int)cudaFree(ptr); }

int mailbox_export(void* ptr, unsigned char* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return (int)err;
}

int mailbox_open(const unsigned char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int mailbox_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

const char* mailbox_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
