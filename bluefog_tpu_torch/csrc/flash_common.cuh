// What the bf16 (flash_attention.cu) and float32 (flash_attention_f32.cu)
// flash kernels share: the TPU kernels' constants, and the choice of the
// head-dim instance a C call runs.
//
// A source builds one instance, -DFLASH_D=<instance>, or the wide route
// of every head dim past 256, -DFLASH_D=0 (flash_wide.cuh)
// (ops/flash_attention.load_library builds one library per dtype and
// instance, and of the float32 source per copy route, all at once, so that
// the build takes the time of its slowest library).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#ifndef FLASH_D
#error "build with -DFLASH_D=<head-dim instance>"
#endif

namespace flash {

constexpr float kMask = -1e30f;  // the TPU kernels' _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Runs f(std::integral_constant<int, Dm>) into *rc when lo < D <= Dm (the
// instance of head dim D; cudaErrorInvalidValue if this build is another
// instance's) and returns whether it was D's instance.
template <int Dm, typename F>
bool instance(int D, int lo, F& f, int* rc) {
  if (D <= lo || D > Dm) return false;
  if constexpr (FLASH_D == Dm)
    *rc = (int)f(std::integral_constant<int, Dm>());
  else
    *rc = (int)cudaErrorInvalidValue;
  return true;
}

// The wide route's build, -DFLASH_D=0: every head dim past kWidest.
constexpr int kWide = 0;
constexpr int kWidest = 256;

// As instance(), for the wide route: runs f(integral_constant<int, kWide>)
// when D > kWidest.
template <typename F>
bool wide(int D, F& f, int* rc) {
  if (D <= kWidest) return false;
  if constexpr (FLASH_D == kWide)
    *rc = (int)f(std::integral_constant<int, kWide>());
  else
    *rc = (int)cudaErrorInvalidValue;
  return true;
}

}  // namespace flash
