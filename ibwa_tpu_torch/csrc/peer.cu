// Peer access between two cards, for a block table split by rows over them
// (B8, fm_row.cuh ShardRows): after this call, kernels running on `device`
// may dereference allocations of `peer` (over NVLink where the cards have
// it).  It is the only way the package makes a peer address usable, and
// fm/device.py::enable_peer the only caller; shard_pair calls it for every
// range that lies on another card than the launching one.  Nothing falls
// back to a host gather or to a copy of the table: a pair of cards that
// cannot reach each other is an error here (cudaErrorPeerAccessUnsupported)
// and a ValueError in the caller, which asks torch first.

#include <cuda_runtime.h>

extern "C" int ibwa_enable_peer(int device, int peer) {
  if (device == peer) return 0;
  int can = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&can, device, peer);
  if (rc != cudaSuccess) return (int)rc;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();  // not an error here: clear it
    rc = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(rc != cudaSuccess ? rc : back);
}
