// Kernel 1's logistic branch (its M instances), compiled beside the normal
// branch in cdf_pmap.cu.
#include "cdf.cuh"

namespace llicti {

template int launch_cdf_pmap<true>(const PmapArgs&, int, cudaStream_t);
template int occupancy_cdf_pmap<true>(int);

}  // namespace llicti
