// Host-side probe of the general attention pair's tensor maps, for
// probes/_torch_host_split.py: the time one view's maps take to make
// (hopper_common.cuh:make_view_maps and make_view_map_f32, as the kernels'
// C entries call them) and the time of a bare ctypes call with the
// entries' 19 arguments. Built with the kernels' own nvcc flags and -I on
// vaw_torch/ops/csrc.

#include <chrono>

#include "hopper_common.cuh"

using namespace vaw_hopper;

namespace {

template <int DP>
bool view_maps(const char* base, int batch, int seq, int heads, int dim,
               const long long* strides) {
  ViewMaps<DP> maps;
  return make_view_maps<DP>(&maps, base, batch, seq, heads, dim, strides);
}

bool one_view(int dp, int rows, const char* base, int batch, int seq, int heads, int dim,
              const long long* strides) {
  switch (dp) {
    case 0: {
      CUtensorMap map;
      return make_view_map_f32(&map, base, batch, seq, heads, dim, strides, rows);
    }
    case 32: return view_maps<32>(base, batch, seq, heads, dim, strides);
    case 64: return view_maps<64>(base, batch, seq, heads, dim, strides);
    case 80: return view_maps<80>(base, batch, seq, heads, dim, strides);
    case 96: return view_maps<96>(base, batch, seq, heads, dim, strides);
    case 128: return view_maps<128>(base, batch, seq, heads, dim, strides);
    default: return false;
  }
}

}  // namespace

// Nanoseconds a view's maps take to make, over `n` makes: the bf16 maps
// of AttnGeo<dp> (dp 32-128), or with dp 0 the f32 map of `rows` rows.
// Make i has base `base` + i * `step` bytes: a step of 0 makes one view's
// maps again and again, a step of 1024 a new view each time. -1 if one
// is refused.
extern "C" double probe_view_maps_ns(int dp, int rows, int n, const void* base,
                                     long long step, int batch, int seq, int heads,
                                     int dim, const long long* strides) {
  const char* b = static_cast<const char*>(base);
  if (!one_view(dp, rows, b, batch, seq, heads, dim, strides)) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) {
    if (!one_view(dp, rows, b + i * step, batch, seq, heads, dim, strides)) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / n;
}

// A ctypes call with the backward entries' argument list that does nothing.
extern "C" int probe_noop(const void*, const void*, const void*, const void*, const void*,
                          const void*, void*, long long, void*, void*, void*,
                          const long long*, int, int, int, int, int, float, void*) {
  return 0;
}
