// Native floor-map bank generators of apx_torch (a copy of the JAX
// package's native/apx_native.cpp; the port neither reads nor builds that
// directory).
//
// The reference (TimSchneider42/active-perception-gym) generates one map
// per episode in recursive Python, a per-reset host cost. These generators
// are C++, parallel over whole banks with std::thread, so a 100k-map bank
// materializes in seconds.
//
// Determinism: each map is a pure function of its 64-bit index (seeded
// splitmix64 -> pcg32). The native generators are NOT draw-compatible with
// the NumPy PCG64 chains of the reference (the Python generators in
// apx_torch/data/floor_map.py are); every map they make is bitwise the one
// the JAX package's native backend makes for the same index.
//
// C API (ctypes-friendly):
//   apx_generate_maze_bank(indices, n, w, h, branching_prob_milli, out)
//   apx_generate_rooms_bank(indices, n, w, h, max_rooms, door_width, out)
//   out: n*w*h bytes, 1 = wall.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// RNG: splitmix64 seeding + pcg32 stream
// ---------------------------------------------------------------------------

struct Pcg32 {
  uint64_t state;
  uint64_t inc;

  explicit Pcg32(uint64_t seed) {
    // splitmix64 to spread the index bits.
    auto mix = [](uint64_t& x) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      return z ^ (z >> 31);
    };
    uint64_t s = seed;
    state = mix(s);
    inc = mix(s) | 1ULL;
    next();
  }

  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + inc;
    uint32_t xorshifted = static_cast<uint32_t>(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = static_cast<uint32_t>(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
  }

  // Unbiased bounded draw (Lemire).
  uint32_t bounded(uint32_t bound) {
    uint64_t m = static_cast<uint64_t>(next()) * bound;
    uint32_t lo = static_cast<uint32_t>(m);
    if (lo < bound) {
      uint32_t t = (-bound) % bound;
      while (lo < t) {
        m = static_cast<uint64_t>(next()) * bound;
        lo = static_cast<uint32_t>(m);
      }
    }
    return static_cast<uint32_t>(m >> 32);
  }

  double uniform() { return next() * (1.0 / 4294967296.0); }
};

// ---------------------------------------------------------------------------
// Maze: recursive backtracker with branching probability (behavioral
// equivalent of floor_map_dataset_maze.py:24-55, iterative form).
// ---------------------------------------------------------------------------

void generate_maze(uint64_t idx, int w, int h, double branching_prob,
                   uint8_t* out) {
  std::memset(out, 1, static_cast<size_t>(w) * h);
  Pcg32 rng(idx);

  struct Frame {
    int x, y;
    int dirs[4];
    int next_dir;
    bool carved_any;
  };

  auto cell = [&](int x, int y) -> uint8_t& { return out[y * w + x]; };
  static const int DX[4] = {2, -2, 0, 0};
  static const int DY[4] = {0, 0, 2, -2};

  std::vector<Frame> stack;
  stack.reserve(static_cast<size_t>(w) * h / 2);

  auto push = [&](int x, int y) {
    Frame f{x, y, {0, 1, 2, 3}, 0, false};
    // Fisher-Yates with the per-map rng.
    for (int i = 3; i > 0; --i) {
      int j = static_cast<int>(rng.bounded(static_cast<uint32_t>(i + 1)));
      int t = f.dirs[i];
      f.dirs[i] = f.dirs[j];
      f.dirs[j] = t;
    }
    stack.push_back(f);
  };

  cell(1, 1) = 0;
  push(1, 1);
  while (!stack.empty()) {
    Frame& f = stack.back();
    bool descended = false;
    while (f.next_dir < 4) {
      int d = f.dirs[f.next_dir++];
      int nx = f.x + DX[d], ny = f.y + DY[d];
      if (nx > 0 && nx < w - 1 && ny > 0 && ny < h - 1 && cell(nx, ny)) {
        if (!f.carved_any || rng.uniform() < branching_prob) {
          cell(f.x + DX[d] / 2, f.y + DY[d] / 2) = 0;
          cell(nx, ny) = 0;
          f.carved_any = true;
          push(nx, ny);
          descended = true;
          break;
        }
      }
    }
    if (!descended && f.next_dir >= 4) stack.pop_back();
  }
}

// ---------------------------------------------------------------------------
// Rooms: recursive splitting with doors (behavioral equivalent of
// floor_map_dataset_rooms.py:25-89). Works on an int8 grid where
// 1 = wall, -1 = door (protected), 0 = free; operates on strided views so
// the alternating-orientation recursion mirrors the reference's .T trick.
// ---------------------------------------------------------------------------

struct View {
  int8_t* data;
  int rows, cols;
  int rstride, cstride;  // element strides

  int8_t& at(int r, int c) { return data[r * rstride + c * cstride]; }
  View transposed() const { return View{data, cols, rows, cstride, rstride}; }
  View slice_rows(int r0, int r1) const {  // [r0, r1)
    return View{data + r0 * rstride, r1 - r0, cols, rstride, cstride};
  }
};

// Split `total` into `parts` non-negative integers via sorted distinct cuts.
void partition_sizes(int total, int parts, Pcg32& rng, int* out) {
  // Reservoir of candidate cut points: max(0, parts - total) zeros followed
  // by 1..total-1 (mirrors the reference's candidate construction).
  int zeros = parts - total > 0 ? parts - total : 0;
  int nvals = total - 1 > 0 ? total - 1 : 0;  // arange(1, total) is empty
                                              // for total <= 1
  int ncand = zeros + nvals;
  std::vector<int> cand(static_cast<size_t>(ncand));
  for (int i = 0; i < zeros; ++i) cand[i] = 0;
  for (int i = 0; i < nvals; ++i) cand[zeros + i] = i + 1;
  // Partial Fisher-Yates to choose parts-1 without replacement.
  int k = parts - 1;
  for (int i = 0; i < k; ++i) {
    int j = i + static_cast<int>(rng.bounded(static_cast<uint32_t>(ncand - i)));
    int t = cand[i];
    cand[i] = cand[j];
    cand[j] = t;
  }
  std::vector<int> cuts(cand.begin(), cand.begin() + k);
  std::sort(cuts.begin(), cuts.end());
  int prev = 0;
  for (int i = 0; i < k; ++i) {
    out[i] = cuts[i] - prev;
    prev = cuts[i];
  }
  out[k] = total - prev;
}

int binomial(int n, double p, Pcg32& rng) {
  int c = 0;
  for (int i = 0; i < n; ++i) c += rng.uniform() < p ? 1 : 0;
  return c;
}

void split_room(View room, int budget, int min_room, int door_width,
                Pcg32& rng) {
  int cap = (room.rows - min_room) / (min_room + 1) + 1;
  if (budget < cap) cap = budget;
  if (cap <= 1) return;
  int n_sub = binomial(cap - 2, 0.3, rng) + 2;

  std::vector<int> sub_budget(static_cast<size_t>(n_sub));
  partition_sizes(cap, n_sub, rng, sub_budget.data());

  std::vector<int> sizes(static_cast<size_t>(n_sub));
  partition_sizes(room.rows - n_sub * (1 + min_room) + 1, n_sub, rng,
                  sizes.data());
  for (int& s : sizes) s += min_room;

  std::vector<int> ends(static_cast<size_t>(n_sub)),
      starts(static_cast<size_t>(n_sub));
  int acc = 0;
  for (int i = 0; i < n_sub; ++i) {
    acc += sizes[i] + 1;
    ends[i] = acc - 1;
    starts[i] = i == 0 ? 0 : ends[i - 1] + 2;
  }

  std::vector<int> doors(static_cast<size_t>(n_sub - 1));
  for (int i = 0; i < n_sub - 1; ++i)
    doors[i] =
        static_cast<int>(rng.bounded(static_cast<uint32_t>(room.cols - door_width)));

  for (int i = 0; i < n_sub - 1; ++i) {
    int wallr = starts[i + 1] - 1;
    for (int c = 0; c < room.cols; ++c)
      if (room.at(wallr, c) != -1) room.at(wallr, c) = 1;
  }
  for (int i = 0; i < n_sub - 1; ++i) {
    int wallr = starts[i + 1] - 1;
    for (int dr = 0; dr < door_width; ++dr)
      for (int dc = 0; dc < door_width; ++dc) {
        int r1 = wallr + dr, r2 = wallr - dr;
        int c = doors[i] + dc;
        if (r1 >= 0 && r1 < room.rows) room.at(r1, c) = -1;
        if (r2 >= 0 && r2 < room.rows) room.at(r2, c) = -1;
      }
  }

  for (int i = 0; i < n_sub; ++i) {
    // numpy slices clip at the array end (the reference's last room's
    // nominal end is rows+1); mirror that.
    int e1 = ends[i] + 1 < room.rows ? ends[i] + 1 : room.rows;
    split_room(room.slice_rows(starts[i], e1).transposed(), sub_budget[i],
               min_room, door_width, rng);
  }
}

void generate_rooms(uint64_t idx, int w, int h, int max_rooms, int door_width,
                    uint8_t* out) {
  Pcg32 rng(idx);
  std::vector<int8_t> grid(static_cast<size_t>(w) * h, 0);
  for (int c = 0; c < w; ++c) grid[c] = grid[(h - 1) * w + c] = 1;
  for (int r = 0; r < h; ++r) grid[r * w] = grid[r * w + (w - 1)] = 1;

  View inner{grid.data() + w + 1, h - 2, w - 2, w, 1};
  int min_room = door_width + 2;
  split_room(inner, max_rooms, min_room, door_width, rng);

  bool transpose = rng.bounded(2) == 0;
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) {
      int8_t v = transpose ? grid[c * w + r] : grid[r * w + c];
      out[r * w + c] = v == 1 ? 1 : 0;
    }
}

// std::thread work-stealing loop (not OpenMP: host Python processes often
// already carry a different OpenMP runtime, and mixing them corrupts the
// allocator).
template <typename F>
void parallel_for(int n, F&& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int workers = static_cast<int>(hw ? hw : 4);
  if (workers > n) workers = n > 0 ? n : 1;
  std::atomic<int> next(0);
  auto run = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) body(i);
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(run);
  run();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void apx_generate_maze_bank(const uint64_t* indices, int n, int w, int h,
                            int branching_prob_milli, uint8_t* out) {
  double p = branching_prob_milli / 1000.0;
  size_t stride = static_cast<size_t>(w) * h;
  parallel_for(n, [&](int i) { generate_maze(indices[i], w, h, p, out + i * stride); });
}

void apx_generate_rooms_bank(const uint64_t* indices, int n, int w, int h,
                             int max_rooms, int door_width, uint8_t* out) {
  size_t stride = static_cast<size_t>(w) * h;
  parallel_for(n, [&](int i) {
    generate_rooms(indices[i], w, h, max_rooms, door_width, out + i * stride);
  });
}

int apx_native_version() { return 1; }

}  // extern "C"
