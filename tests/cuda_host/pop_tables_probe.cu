// Test probes: fills the kernels' population tables (PopTables::load in
// gphocs_tpu_torch/csrc/sweeps_common.cuh) from a SweepArgs on the host and
// copies them out, so that tests/test_torch_csrc_host.py can hold pop_end
// and the band windows against kernels/common.py; and the stand-in
// runtime's kernel attributes (cuda_runtime.h), which a test sets and reads.
#include "sweeps_common.cuh"

int host_static_smem = 0, host_attr_reads = 0, host_opt_in_bytes = 0;

// every kernel's static shared memory from now on (a library reads it once
// per kernel and real type)
extern "C" void host_set_static_smem(int bytes) { host_static_smem = bytes; }
// out = [reads of a kernel's attributes, the last opt-in's bytes (0: none)]
extern "C" void host_attributes(int* out) {
  out[0] = host_attr_reads;
  out[1] = host_opt_in_bytes;
}

// out = [theta (PP), tau (PP), pop_end (PP), band start, end, rate (B each)]
extern "C" void pop_tables_probe_f64(const SweepArgs* a, int proposal,
                                     double* out) {
  static PopTables<double> pt;
  blockIdx.x = blockIdx.y = 0;
  blockDim.x = 1;
  threadIdx.x = 0;
  pt.load(*a, proposal != 0, 0);
  const int PP = a->PP, B = a->B;
  for (int j = 0; j < PP; ++j) {
    out[j] = pt.theta[j];
    out[PP + j] = pt.tau[j];
    out[2 * PP + j] = pt.pend[j];
  }
  for (int b = 0; b < B; ++b) {
    out[3 * PP + b] = pt.bs[b];
    out[3 * PP + B + b] = pt.be[b];
    out[3 * PP + 2 * B + b] = pt.rate[b];
  }
}
