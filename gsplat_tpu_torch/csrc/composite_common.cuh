// Constants shared by the forward and backward composite kernels
// (composite_fwd.cuh, composite_bwd.cuh).
#pragma once

namespace {

constexpr int kMaxThreads = 1024;  // TILE_X * TILE_Y must not exceed this
constexpr int kGeo = 6;            // mean x, mean y, conic a, b, c, opacity
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kLog2e = 1.4426950408889634f;

}  // namespace
