// skelio: the port's native host-side data kernels (a copy of the JAX
// package's agcn_tpu/native/skelio.cpp; only this comment differs).
//
// Built by g++ at first use into agcn_tpu_torch/build/ and bound with
// ctypes by agcn_tpu_torch/native/__init__.py. Where the port calls them:
//
//  - pre_normalize: data/gen/preprocess.py pre_normalization, which the
//    serving tick (infer/serving.py BatchedStreamServer, one call per
//    batched tick), the single-stream path (infer/preprocess.py
//    dense_input) and the offline generators (data/gen/ntu.py,
//    data/gen/openpose.py) run.
//  - parse_skeleton: NTU RGB+D `.skeleton` text parsing for data/gen/ntu.py
//    read_xyz (the `ntu`, `openpose` and `explore` subcommands of
//    python -m agcn_tpu_torch.data.gen).
//  - flatten_persons: the SGN collate loop; not bound by the port yet.
//
// Exposed as a plain C ABI for ctypes; no Python headers needed.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Fast float token scanner over a memory buffer.
struct Scanner {
  const char* p;
  const char* end;

  explicit Scanner(const char* data, size_t len)
      : p(data), end(data + len) {}

  bool skip_ws() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      ++p;
    return p < end;
  }

  bool next_double(double* out) {
    if (!skip_ws()) return false;
    char* next = nullptr;
    *out = strtod(p, &next);
    if (next == p) return false;
    p = next;
    return true;
  }

  bool next_int(long* out) {
    double v;
    if (!next_double(&v)) return false;
    *out = static_cast<long>(v);
    return true;
  }

  // skip to end of current line
  void skip_line() {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
};

}  // namespace

extern "C" {

// Parse one NTU `.skeleton` file into out[(max_body, max_frames,
// num_joint, 3)]. Returns the number of frames parsed, or -1 on error.
// Layout of each body line: 10 metadata floats, then joint count, then
// per joint 12 floats of which the first 3 are xyz.
int parse_skeleton(const char* path, float* out, int max_body,
                   int max_frames, int num_joint) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  if (size > 0 && fread(buf.data(), 1, static_cast<size_t>(size), f) !=
      static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);

  Scanner sc(buf.data(), buf.size());
  long num_frame = 0;
  if (!sc.next_int(&num_frame)) return -1;

  const long frames = num_frame < max_frames ? num_frame : max_frames;
  memset(out, 0,
         sizeof(float) * static_cast<size_t>(max_body) *
             static_cast<size_t>(max_frames) *
             static_cast<size_t>(num_joint) * 3);

  for (long t = 0; t < num_frame; ++t) {
    long num_body = 0;
    if (!sc.next_int(&num_body)) return -1;
    for (long b = 0; b < num_body; ++b) {
      // 10 body-info floats (bodyID may be a large integer token)
      double tmp;
      for (int k = 0; k < 10; ++k)
        if (!sc.next_double(&tmp)) return -1;
      long nj = 0;
      if (!sc.next_int(&nj)) return -1;
      for (long j = 0; j < nj; ++j) {
        double x, y, z;
        if (!sc.next_double(&x) || !sc.next_double(&y) ||
            !sc.next_double(&z))
          return -1;
        // remaining 9 floats of the joint line
        for (int k = 0; k < 9; ++k)
          if (!sc.next_double(&tmp)) return -1;
        if (b < max_body && j < num_joint && t < frames) {
          size_t idx = ((static_cast<size_t>(b) * max_frames + t) *
                            num_joint +
                        j) *
                       3;
          out[idx + 0] = static_cast<float>(x);
          out[idx + 1] = static_cast<float>(y);
          out[idx + 2] = static_cast<float>(z);
        }
      }
    }
  }
  return static_cast<int>(frames);
}

// SGN collate core: drop all-zero frames of seq[(t, 2*half)], interleave
// the two person halves into time order, writing frames[(out_cap, half)]
// and subjects[(out_cap, 1)]. Returns the number of output frames.
int flatten_persons(const float* seq, int t, int half, float* frames,
                    float* subjects, int out_cap) {
  int count = 0;
  for (int i = 0; i < t && count < out_cap; ++i) {
    const float* row = seq + static_cast<size_t>(i) * 2 * half;
    const float* p0 = row;
    const float* p1 = row + half;
    bool z0 = true, z1 = true;
    for (int k = 0; k < half; ++k) {
      if (p0[k] != 0.0f) { z0 = false; break; }
    }
    for (int k = 0; k < half; ++k) {
      if (p1[k] != 0.0f) { z1 = false; break; }
    }
    if (z0 && z1) continue;  // drop all-zero frame
    if (z0 && !z1) {
      memcpy(frames + static_cast<size_t>(count) * half, p1,
             sizeof(float) * half);
      subjects[count] = 1.0f;
      ++count;
    } else if (z1) {
      memcpy(frames + static_cast<size_t>(count) * half, p0,
             sizeof(float) * half);
      subjects[count] = 0.0f;
      ++count;
    } else {
      memcpy(frames + static_cast<size_t>(count) * half, p0,
             sizeof(float) * half);
      subjects[count] = 0.0f;
      ++count;
      if (count < out_cap) {
        memcpy(frames + static_cast<size_t>(count) * half, p1,
               sizeof(float) * half);
        subjects[count] = 1.0f;
        ++count;
      }
    }
  }
  return count;
}

}

// ---------------------------------------------------------------------
// pre_normalize: skeleton sequence normalization (the gen/serving host
// hot spot — agcn_tpu/data/gen/preprocess.py pre_normalization, itself
// the vectorized form of reference data_gen/preprocess.py:13-147).
// Layout: s is (N, M, T, V, 3) float32, modified in place. Pass
// z_from/z_to = -1 (or x_*) to skip an alignment; center_mode:
// 0 none, 1 whole-sequence spine centering, 2 first-valid-frame.
// All reductions/rotations run in double like the numpy/float64 path.

static double frame_sum(const float* f, int len) {
  double s = 0.0;
  for (int k = 0; k < len; ++k) s += f[k];
  return s;
}

static void align_matrix(const double* bone, const double* target,
                         double mat[3][3]) {
  // align_rotation (rotation.py): Rodrigues about cross(bone, target)
  // by angle_between(bone, target); identity on degenerate input.
  double axis[3] = {bone[1] * target[2] - bone[2] * target[1],
                    bone[2] * target[0] - bone[0] * target[2],
                    bone[0] * target[1] - bone[1] * target[0]};
  double v1 = std::abs(bone[0]) + std::abs(bone[1]) + std::abs(bone[2]);
  double v2 = std::abs(target[0]) + std::abs(target[1])
      + std::abs(target[2]);
  double theta = 0.0;
  if (v1 >= 1e-6 && v2 >= 1e-6) {
    double n1 = std::sqrt(bone[0] * bone[0] + bone[1] * bone[1]
                          + bone[2] * bone[2]);
    double n2 = std::sqrt(target[0] * target[0] + target[1] * target[1]
                          + target[2] * target[2]);
    double d = (bone[0] / n1) * (target[0] / n2)
        + (bone[1] / n1) * (target[1] / n2)
        + (bone[2] / n1) * (target[2] / n2);
    if (d > 1.0) d = 1.0;
    if (d < -1.0) d = -1.0;
    theta = std::acos(d);
  }
  double asum = std::abs(axis[0]) + std::abs(axis[1]) + std::abs(axis[2]);
  if (asum < 1e-6 || std::abs(theta) < 1e-6) {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) mat[i][j] = (i == j) ? 1.0 : 0.0;
    return;
  }
  double norm = std::sqrt(axis[0] * axis[0] + axis[1] * axis[1]
                          + axis[2] * axis[2]);
  double a = std::cos(theta / 2.0);
  double b = -(axis[0] / norm) * std::sin(theta / 2.0);
  double c = -(axis[1] / norm) * std::sin(theta / 2.0);
  double d = -(axis[2] / norm) * std::sin(theta / 2.0);
  double aa = a * a, bb = b * b, cc = c * c, dd = d * d;
  double bc = b * c, ad = a * d, ac = a * c, ab = a * b, bd = b * d,
      cd = c * d;
  mat[0][0] = aa + bb - cc - dd; mat[0][1] = 2 * (bc + ad);
  mat[0][2] = 2 * (bd - ac);
  mat[1][0] = 2 * (bc - ad); mat[1][1] = aa + cc - bb - dd;
  mat[1][2] = 2 * (cd + ab);
  mat[2][0] = 2 * (bd + ac); mat[2][1] = 2 * (cd - ab);
  mat[2][2] = aa + dd - bb - cc;
}

extern "C" void pre_normalize(float* s, int n, int m, int t, int v,
                              int z_from, int z_to, int x_from, int x_to,
                              int do_pad, int center_mode) {
  const size_t person_len = static_cast<size_t>(t) * v * 3;
  const size_t frame_len = static_cast<size_t>(v) * 3;
  std::vector<float> tmp(person_len);
  std::vector<float> centers(static_cast<size_t>(t) * 3);
  for (int i_s = 0; i_s < n; ++i_s) {
    float* skel = s + static_cast<size_t>(i_s) * m * person_len;
    double total = 0.0;
    for (size_t k = 0; k < static_cast<size_t>(m) * person_len; ++k)
      total += skel[k];
    if (total == 0.0) continue;

    if (do_pad) {
      for (int i_p = 0; i_p < m; ++i_p) {
        float* person = skel + static_cast<size_t>(i_p) * person_len;
        if (frame_sum(person, person_len) == 0.0) continue;
        // shift leading zero frames out (keep valid frames in order)
        if (frame_sum(person, frame_len) == 0.0) {
          size_t w = 0;
          for (int f = 0; f < t; ++f) {
            float* fr = person + static_cast<size_t>(f) * frame_len;
            if (frame_sum(fr, frame_len) != 0.0)
              memcpy(tmp.data() + (w++) * frame_len, fr,
                     sizeof(float) * frame_len);
          }
          memset(person, 0, sizeof(float) * person_len);
          memcpy(person, tmp.data(), sizeof(float) * w * frame_len);
        }
        // tile the valid prefix over an all-zero tail; per-frame sums
        // + suffix sums keep this O(T*V) instead of O(T^2*V)
        std::vector<double> suffix(t + 1, 0.0);
        for (int f = t - 1; f >= 0; --f)
          suffix[f] = suffix[f + 1]
              + frame_sum(person + static_cast<size_t>(f) * frame_len,
                          frame_len);
        for (int f = 1; f < t; ++f) {
          if (suffix[f] == 0.0
              && suffix[f] - suffix[f + 1] == 0.0) {
            for (int g = f; g < t; ++g)
              memcpy(person + static_cast<size_t>(g) * frame_len,
                     person + static_cast<size_t>(g % f) * frame_len,
                     sizeof(float) * frame_len);
            break;
          }
        }
      }
    }

    if (center_mode != 0) {
      const float* p0 = skel;  // person 0
      if (center_mode == 1) {
        for (int f = 0; f < t; ++f)
          memcpy(centers.data() + static_cast<size_t>(f) * 3,
                 p0 + static_cast<size_t>(f) * frame_len + 3,  // joint 1
                 sizeof(float) * 3);
      } else {
        int f0 = 0;
        while (f0 < t - 1) {
          const float* fr = p0 + static_cast<size_t>(f0) * frame_len;
          bool any = false;
          for (size_t k = 0; k < frame_len; ++k)
            if (fr[k] != 0.0f) { any = true; break; }
          if (any) break;
          ++f0;
        }
        for (int f = 0; f < t; ++f)
          memcpy(centers.data() + static_cast<size_t>(f) * 3,
                 p0 + static_cast<size_t>(f0) * frame_len + 3,
                 sizeof(float) * 3);
      }
      for (int i_p = 0; i_p < m; ++i_p) {
        float* person = skel + static_cast<size_t>(i_p) * person_len;
        if (frame_sum(person, person_len) == 0.0) continue;
        for (int f = 0; f < t; ++f) {
          float* fr = person + static_cast<size_t>(f) * frame_len;
          const float* ctr = centers.data() + static_cast<size_t>(f) * 3;
          for (int j = 0; j < v; ++j) {
            float* pt = fr + static_cast<size_t>(j) * 3;
            // float accumulation like numpy's float32 sum
            float js = (pt[0] + pt[1]) + pt[2];
            float mask = (js != 0.0f) ? 1.0f : 0.0f;
            for (int k = 0; k < 3; ++k)
              pt[k] = (pt[k] - ctr[k]) * mask;
          }
        }
      }
    }

    // sequential axis alignments: (z_from -> z_to) to +z, then
    // (x_from -> x_to) to +x on the already-rotated skeleton
    const double targets[2][3] = {{0.0, 0.0, 1.0}, {1.0, 0.0, 0.0}};
    const int pairs[2][2] = {{z_from, z_to}, {x_from, x_to}};
    for (int a = 0; a < 2; ++a) {
      if (pairs[a][0] < 0 || pairs[a][1] < 0) continue;
      const float* from = skel + static_cast<size_t>(pairs[a][0]) * 3;
      const float* to = skel + static_cast<size_t>(pairs[a][1]) * 3;
      double bone[3] = {static_cast<double>(to[0]) - from[0],
                        static_cast<double>(to[1]) - from[1],
                        static_cast<double>(to[2]) - from[2]};
      double mat[3][3];
      align_matrix(bone, targets[a], mat);
      for (int i_p = 0; i_p < m; ++i_p) {
        float* person = skel + static_cast<size_t>(i_p) * person_len;
        if (frame_sum(person, person_len) == 0.0) continue;
        for (int f = 0; f < t; ++f) {
          float* fr = person + static_cast<size_t>(f) * frame_len;
          if (frame_sum(fr, frame_len) == 0.0) continue;  // stays as-is
          for (int j = 0; j < v; ++j) {
            float* pt = fr + static_cast<size_t>(j) * 3;
            double x = pt[0], y = pt[1], z = pt[2];
            pt[0] = static_cast<float>(mat[0][0] * x + mat[0][1] * y
                                       + mat[0][2] * z);
            pt[1] = static_cast<float>(mat[1][0] * x + mat[1][1] * y
                                       + mat[1][2] * z);
            pt[2] = static_cast<float>(mat[2][0] * x + mat[2][1] * y
                                       + mat[2][2] * z);
          }
        }
      }
    }
  }
}
