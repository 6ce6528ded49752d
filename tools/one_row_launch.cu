// Launch styles of an empty kernel, for tools/one_row_probe.py's `launch`
// part: what each costs the host a launch. plain: <<<>>>; ex: through
// cudaLaunchKernelEx, with a runtime cluster dimension when ctas > 0 (the
// split route's launch); static8: a kernel compiled with __cluster_dims__(8)
// launched by <<<>>>.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void k_plain() {}
__global__ void k_cluster() { cg::this_cluster().sync(); }
__global__ void __cluster_dims__(8, 1, 1) k_static8() { cg::this_cluster().sync(); }

extern "C" int launch_plain(int blocks, void* s) {
  k_plain<<<blocks, 256, 0, (cudaStream_t)s>>>();
  return (int)cudaGetLastError();
}

extern "C" int launch_ex(int blocks, int ctas, void* s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 0 ? 1 : 0;
  const cudaError_t e = ctas > 0 ? cudaLaunchKernelEx(&cfg, k_cluster)
                                 : cudaLaunchKernelEx(&cfg, k_plain);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int launch_static8(int blocks, void* s) {
  k_static8<<<blocks, 256, 0, (cudaStream_t)s>>>();
  return (int)cudaGetLastError();
}
