// Native Paikin-Tal greedy placement core.
//
// C++ implementation of the solver's host-side placement loop
// (mirrors vit_ed_tpu_torch/solver/solver.py + distance.py, which
// themselves re-create the reference's paikin_tal_solver/solver.py and
// inter_piece_distance.py). The port's copy of vit_ed_tpu/native/
// paikin_tal.cc, built with g++ at its first use by native/solver.py.
// The device computes the [4, N, N] distance tensor; this library owns
// everything after that: min/second-best tracking, asymmetric/mutual
// compatibility, best buddies, start-piece ordering, the best-buddy heap,
// open-slot management, board-dimension enforcement, the placement loop,
// and the masked recalculation path.
//
// Type-1 puzzles (no piece rotation): the side pairing is always
// complementary, so all arrays are indexed [side][i][j].
//
// Exposed C API (ctypes):
//   int pt_solve(int n, const double* D /* [4*n*n] */,
//                int fixed_rows, int fixed_cols,   /* <=0: unconstrained */
//                int numb_puzzles, double new_board_compat,
//                int* out_rows, int* out_cols, int* out_puzzle_id);
// Returns 0 on success.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <tuple>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr double kMaxsize = 9.2233720368547758e18;       // ~sys.maxsize
constexpr int kComp[4] = {2, 3, 0, 1};                   // complementary side

struct Engine {
  int n;
  std::vector<double> D;        // [4][n][n], D[s][i][i] = inf
  std::vector<double> min_d;    // [4][n]
  std::vector<double> second_d; // [4][n]
  std::vector<int> candidate;   // [4][n] unique argmin or -1
  std::vector<double> acompat;  // [4][n][n]
  std::vector<double> mutual;   // [4][n][n]
  std::vector<int> bb;          // [4][n] best buddy or -1
  std::vector<std::tuple<int, long long, double>> start_order; // (i, nbb, compat)

  inline double& d(int s, int i, int j) { return D[(s * n + i) * n + j]; }
  inline double& ac(int s, int i, int j) { return acompat[(s * n + i) * n + j]; }
  inline double& mc(int s, int i, int j) { return mutual[(s * n + i) * n + j]; }

  void init(const double* dist, int n_) {
    n = n_;
    D.assign(dist, dist + 4LL * n * n);
    for (int s = 0; s < 4; ++s)
      for (int i = 0; i < n; ++i) d(s, i, i) = kInf;
    min_d.resize(4 * n);
    second_d.resize(4 * n);
    candidate.resize(4 * n);
    acompat.resize(4LL * n * n);
    mutual.resize(4LL * n * n);
    bb.resize(4 * n);
    recompute(nullptr, nullptr);
    find_best_buddies();
    find_start_order();
  }

  // Masked min/second-best with the reference's sentinel semantics
  // (inter_piece_distance.py:275-287): placed_j pieces are excluded.
  void recompute(const uint8_t* placed_j, const uint8_t* placed_no_open) {
    if (placed_no_open == nullptr) placed_no_open = placed_j;
    for (int s = 0; s < 4; ++s) {
      for (int i = 0; i < n; ++i) {
        double m1 = kInf, m2 = kInf;
        int arg = -1, n_min = 0;
        for (int j = 0; j < n; ++j) {
          double v = d(s, i, j);
          if (placed_j && placed_j[j]) continue;
          if (!std::isfinite(v)) continue;
          if (v < m1) {
            m2 = m1;
            m1 = v;
            arg = j;
            n_min = 1;
          } else if (v == m1) {
            m2 = v;
            ++n_min;
          } else if (v < m2) {
            m2 = v;
          }
        }
        int idx = s * n + i;
        if (arg < 0) {                       // no valid piece
          min_d[idx] = kMaxsize - 1;
          second_d[idx] = kMaxsize;
          candidate[idx] = -1;
        } else {
          min_d[idx] = m1;
          second_d[idx] = std::isfinite(m2) ? m2 : kMaxsize - 1;
          candidate[idx] = (n_min == 1) ? arg : -1;
        }
      }
    }
    // asymmetric compatibility (inter_piece_distance.py:356-369)
    for (int s = 0; s < 4; ++s) {
      for (int i = 0; i < n; ++i) {
        double sec = second_d[s * n + i];
        for (int j = 0; j < n; ++j) {
          double v = d(s, i, j);
          double out;
          if (!std::isfinite(v) || (placed_no_open && placed_no_open[j])) {
            out = -kInf;
          } else if (v == 0) {
            out = 1.0;
          } else if (sec == 0) {
            out = -kMaxsize;
          } else {
            out = 1.0 - v / sec;
          }
          ac(s, i, j) = out;
        }
      }
    }
    // mutual[s][i][j] = (ac[s][i][j] + ac[comp(s)][j][i]) / 2
    for (int s = 0; s < 4; ++s) {
      int cs = kComp[s];
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          mc(s, i, j) = (ac(s, i, j) + acompat[(cs * n + j) * n + i]) / 2.0;
    }
  }

  // bb[s][i] = j iff candidate is mutually unique
  // (inter_piece_distance.py:623-648)
  void find_best_buddies() {
    for (int s = 0; s < 4; ++s) {
      int cs = kComp[s];
      for (int i = 0; i < n; ++i) {
        int j = candidate[s * n + i];
        bb[s * n + i] = (j >= 0 && candidate[cs * n + j] == i) ? j : -1;
      }
    }
  }

  // (inter_piece_distance.py:650-735)
  void find_start_order() {
    std::vector<int> n_bb(n, 0);
    std::vector<double> total_compat(n, 0.0);
    for (int i = 0; i < n; ++i)
      for (int s = 0; s < 4; ++s)
        if (bb[s * n + i] >= 0) {
          ++n_bb[i];
          total_compat[i] += mc(s, i, bb[s * n + i]);
        }
    start_order.clear();
    start_order.reserve(n);
    for (int i = 0; i < n; ++i) {
      long long nb = 4LL * n_bb[i];
      for (int s = 0; s < 4; ++s)
        if (bb[s * n + i] >= 0) nb += n_bb[bb[s * n + i]];
      start_order.emplace_back(i, nb, total_compat[i]);
    }
    std::stable_sort(start_order.begin(), start_order.end(),
                     [](const auto& a, const auto& b) {
                       if (std::get<1>(a) != std::get<1>(b))
                         return std::get<1>(a) > std::get<1>(b);
                       return std::get<2>(a) > std::get<2>(b);
                     });
  }
};

struct OpenSlot {
  int row, col, piece_id, open_side;
};

struct HeapEntry {
  double compat;
  long long counter;   // earlier pushes win ties (python heapq tuple order)
  int bb_id, bb_side, neighbor_id, neighbor_side, row, col;
};

struct HeapCmp {
  bool operator()(const HeapEntry& a, const HeapEntry& b) const {
    if (a.compat != b.compat) return a.compat < b.compat;   // max-heap
    return a.counter > b.counter;
  }
};

struct Solver {
  Engine eng;
  int n;
  int fixed_rows, fixed_cols;
  int numb_puzzles;
  double new_board_compat;

  std::vector<uint8_t> placed;
  std::vector<int> out_row, out_col, out_puzzle;
  std::vector<std::vector<uint8_t>> board;   // per puzzle occupancy
  int board_dim;                              // (2n+3)
  std::vector<OpenSlot> open_slots;
  std::vector<int> bb_pool;                  // insertion-ordered piece ids
  std::vector<uint8_t> in_pool;
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
  long long counter = 0;
  int cur_puzzle = -1;
  int tl_r, tl_c, br_r, br_c;                // placed dims of current puzzle
  int unplaced;

  inline bool occupied(int r, int c) const {
    return board[cur_puzzle][r * board_dim + c] != 0;
  }

  bool slot_open(int r, int c) const {
    if (r < 0 || c < 0 || r >= board_dim || c >= board_dim) return false;
    if (occupied(r, c)) return false;
    if (fixed_rows > 0) {
      // board-dimension enforcement (solver.py:427-443)
      if (r - tl_r + 1 > fixed_rows) return false;
      if (br_r - r + 1 > fixed_rows) return false;
      if (c - tl_c + 1 > fixed_cols) return false;
      if (br_c - c + 1 > fixed_cols) return false;
    }
    return true;
  }

  void heap_push(int bb_id, int bb_side, int nb_id, int nb_side, int r, int c) {
    double compat = eng.mc(bb_side, bb_id, nb_id);
    heap.push({compat, counter++, bb_id, bb_side, nb_id, nb_side, r, c});
  }

  void add_best_buddies_to_pool(int piece_id) {
    for (int s = 0; s < 4; ++s) {
      int j = eng.bb[s * n + piece_id];
      if (j < 0 || placed[j] || in_pool[j]) continue;
      in_pool[j] = 1;
      bb_pool.push_back(j);
      for (const auto& slot : open_slots) {
        int bb_side = kComp[slot.open_side];
        heap_push(j, bb_side, slot.piece_id, slot.open_side, slot.row, slot.col);
      }
    }
  }

  void update_open_slots(int piece_id, int r, int c) {
    const int dr[4] = {-1, 0, 1, 0};   // top, right, bottom, left
    const int dc[4] = {0, 1, 0, -1};
    for (int side = 0; side < 4; ++side) {
      int nr = r + dr[side], nc = c + dc[side];
      if (!slot_open(nr, nc)) continue;
      open_slots.push_back({nr, nc, piece_id, side});
      for (int pi = 0; pi < (int)bb_pool.size(); ++pi) {
        int bid = bb_pool[pi];
        if (!in_pool[bid]) continue;
        int bb_side = kComp[side];
        heap_push(bid, bb_side, piece_id, side, nr, nc);
      }
    }
  }

  void place(int piece_id, int r, int c, bool from_pool) {
    placed[piece_id] = 1;
    --unplaced;
    out_row[piece_id] = r;
    out_col[piece_id] = c;
    out_puzzle[piece_id] = cur_puzzle;
    board[cur_puzzle][r * board_dim + c] = 1;
    tl_r = std::min(tl_r, r);
    tl_c = std::min(tl_c, c);
    br_r = std::max(br_r, r);
    br_c = std::max(br_c, c);
    open_slots.erase(
        std::remove_if(open_slots.begin(), open_slots.end(),
                       [&](const OpenSlot& s) { return s.row == r && s.col == c; }),
        open_slots.end());
    if (from_pool && in_pool[piece_id]) {
      in_pool[piece_id] = 0;
      bb_pool.erase(std::remove(bb_pool.begin(), bb_pool.end(), piece_id),
                    bb_pool.end());
    }
    add_best_buddies_to_pool(piece_id);
    update_open_slots(piece_id, r, c);
  }

  void seed_board() {
    ++cur_puzzle;
    board.emplace_back(board_dim * board_dim, 0);
    int seed = -1;
    for (const auto& t : eng.start_order)
      if (!placed[std::get<0>(t)]) { seed = std::get<0>(t); break; }
    int center = board_dim / 2;
    tl_r = br_r = center;
    tl_c = br_c = center;
    bb_pool.clear();
    std::fill(in_pool.begin(), in_pool.end(), 0);
    while (!heap.empty()) heap.pop();
    open_slots.clear();
    place(seed, center, center, false);
  }

  bool find_next_from_heap(HeapEntry* out) {
    while (!heap.empty()) {
      HeapEntry e = heap.top();
      heap.pop();
      if (!placed[e.bb_id] && slot_open(e.row, e.col)) {
        *out = e;
        return true;
      }
    }
    return false;
  }

  // Exhaustive (unplaced piece) x (open slot) argmax (solver.py:456-499)
  bool find_next_exhaustive(HeapEntry* out) {
    bool found = false;
    double best = -kInf;
    for (const auto& slot : open_slots) {
      if (!slot_open(slot.row, slot.col)) continue;
      int next_side = kComp[slot.open_side];
      for (int i = 0; i < n; ++i) {
        if (placed[i]) continue;
        double c = eng.mc(next_side, i, slot.piece_id);
        if (!found || c > best) {
          best = c;
          *out = {c, 0, i, next_side, slot.piece_id, slot.open_side,
                  slot.row, slot.col};
          found = true;
        }
      }
    }
    return found;
  }

  void recalc() {
    // solver.py:393-411: pieces adjacent to open slots count as available
    std::vector<uint8_t> placed_and_open(placed);
    for (const auto& slot : open_slots) placed_and_open[slot.piece_id] = 0;
    eng.recompute(placed.data(), placed_and_open.data());
  }

  int solve(const double* dist, int n_, int fr, int fc, int np_, double nbc,
            int* rows, int* cols, int* pids, long long* out_bb) {
    n = n_;
    fixed_rows = fr;
    fixed_cols = fc;
    numb_puzzles = np_;
    new_board_compat = nbc;
    eng.init(dist, n);
    placed.assign(n, 0);
    in_pool.assign(n, 0);
    out_row.assign(n, -1);
    out_col.assign(n, -1);
    out_puzzle.assign(n, -1);
    board_dim = 2 * n + 3;
    unplaced = n;
    cur_puzzle = -1;
    if (out_bb != nullptr)   // initial best buddies, before any recalc
      for (int idx = 0; idx < 4 * n; ++idx) out_bb[idx] = eng.bb[idx];
    seed_board();

    while (unplaced > 0) {
      HeapEntry e;
      bool have = !bb_pool.empty() && find_next_from_heap(&e);
      bool from_pool = have;
      if (!have) {
        recalc();
        if (!find_next_exhaustive(&e)) return 1;   // should not happen
      }
      if (cur_puzzle + 1 < numb_puzzles && e.compat < new_board_compat) {
        seed_board();
      } else {
        place(e.bb_id, e.row, e.col, from_pool);
      }
    }

    // normalize each puzzle's locations to its upper-left
    for (int p = 0; p <= cur_puzzle; ++p) {
      int mr = board_dim, mc2 = board_dim;
      for (int i = 0; i < n; ++i)
        if (out_puzzle[i] == p) {
          mr = std::min(mr, out_row[i]);
          mc2 = std::min(mc2, out_col[i]);
        }
      for (int i = 0; i < n; ++i)
        if (out_puzzle[i] == p) {
          out_row[i] -= mr;
          out_col[i] -= mc2;
        }
    }
    std::memcpy(rows, out_row.data(), n * sizeof(int));
    std::memcpy(cols, out_col.data(), n * sizeof(int));
    std::memcpy(pids, out_puzzle.data(), n * sizeof(int));
    return 0;
  }
};

// ---------------------------------------------------------------------------
// Type-2 (rotation-aware): D2[s][i][t][j] over all 16 side pairings,
// min/second over the JOINT (side, piece) space, rotated placement
// (mirrors solver/distance.py::CompatibilityEngine2 and the rotation
// algebra of solver/piece.py, which re-create the reference
// inter_piece_distance.py:189-369 + puzzle_piece.py:611-717).
// ---------------------------------------------------------------------------

struct Engine2 {
  int n;
  std::vector<double> D;        // [4][n][4][n]
  std::vector<double> min_d;    // [4][n]
  std::vector<double> second_d; // [4][n]
  std::vector<long long> candidate; // [4][n] flat t*n+j or -1
  std::vector<double> acompat;  // [4][n][4][n]
  std::vector<long long> bb;    // [4][n] flat t*n+j or -1
  std::vector<std::tuple<int, long long, double>> start_order;

  inline double& d(int s, int i, int t, int j) {
    return D[((s * (long long)n + i) * 4 + t) * n + j];
  }
  inline double& ac(int s, int i, int t, int j) {
    return acompat[((s * (long long)n + i) * 4 + t) * n + j];
  }
  inline double mc(int s, int i, int t, int j) {
    return (ac(s, i, t, j) + ac(t, j, s, i)) / 2.0;
  }

  void init(const double* dist, int n_) {
    n = n_;
    D.assign(dist, dist + 16LL * n * n);
    for (int s = 0; s < 4; ++s)
      for (int i = 0; i < n; ++i)
        for (int t = 0; t < 4; ++t) d(s, i, t, i) = kInf;
    min_d.resize(4 * n);
    second_d.resize(4 * n);
    candidate.resize(4 * n);
    acompat.resize(16LL * n * n);
    bb.resize(4 * n);
    recompute(nullptr, nullptr);
    find_best_buddies();
    find_start_order();
  }

  void recompute(const uint8_t* placed_j, const uint8_t* placed_no_open) {
    if (placed_no_open == nullptr) placed_no_open = placed_j;
    for (int s = 0; s < 4; ++s) {
      for (int i = 0; i < n; ++i) {
        double m1 = kInf, m2 = kInf;
        long long arg = -1;
        int n_min = 0;
        for (int t = 0; t < 4; ++t) {
          for (int j = 0; j < n; ++j) {
            if (placed_j && placed_j[j]) continue;
            double v = d(s, i, t, j);
            if (!std::isfinite(v)) continue;
            if (v < m1) {
              m2 = m1;
              m1 = v;
              arg = (long long)t * n + j;
              n_min = 1;
            } else if (v == m1) {
              m2 = v;
              ++n_min;
            } else if (v < m2) {
              m2 = v;
            }
          }
        }
        int idx = s * n + i;
        if (arg < 0) {
          min_d[idx] = kMaxsize - 1;
          second_d[idx] = kMaxsize;
          candidate[idx] = -1;
        } else {
          min_d[idx] = m1;
          second_d[idx] = std::isfinite(m2) ? m2 : kMaxsize - 1;
          candidate[idx] = (n_min == 1) ? arg : -1;
        }
      }
    }
    for (int s = 0; s < 4; ++s) {
      for (int i = 0; i < n; ++i) {
        double sec = second_d[s * n + i];
        for (int t = 0; t < 4; ++t) {
          for (int j = 0; j < n; ++j) {
            double v = d(s, i, t, j);
            double out;
            if (!std::isfinite(v) || (placed_no_open && placed_no_open[j])) {
              out = -kInf;
            } else if (v == 0) {
              out = 1.0;
            } else if (sec == 0) {
              out = -kMaxsize;
            } else {
              out = 1.0 - v / sec;
            }
            ac(s, i, t, j) = out;
          }
        }
      }
    }
  }

  void find_best_buddies() {
    for (int s = 0; s < 4; ++s) {
      for (int i = 0; i < n; ++i) {
        long long c = candidate[s * n + i];
        if (c < 0) {
          bb[s * n + i] = -1;
          continue;
        }
        int t = (int)(c / n), j = (int)(c % n);
        bb[s * n + i] =
            (candidate[t * n + j] == (long long)s * n + i) ? c : -1;
      }
    }
  }

  void find_start_order() {
    std::vector<int> n_bb(n, 0);
    std::vector<double> total_compat(n, 0.0);
    for (int i = 0; i < n; ++i)
      for (int s = 0; s < 4; ++s) {
        long long c = bb[s * n + i];
        if (c >= 0) {
          ++n_bb[i];
          total_compat[i] += mc(s, i, (int)(c / n), (int)(c % n));
        }
      }
    start_order.clear();
    start_order.reserve(n);
    for (int i = 0; i < n; ++i) {
      long long nb = 4LL * n_bb[i];
      for (int s = 0; s < 4; ++s) {
        long long c = bb[s * n + i];
        if (c >= 0) nb += n_bb[(int)(c % n)];
      }
      start_order.emplace_back(i, nb, total_compat[i]);
    }
    std::stable_sort(start_order.begin(), start_order.end(),
                     [](const auto& a, const auto& b) {
                       if (std::get<1>(a) != std::get<1>(b))
                         return std::get<1>(a) > std::get<1>(b);
                       return std::get<2>(a) > std::get<2>(b);
                     });
  }
};

struct OpenSlot2 {
  int row, col, piece_id, open_side;  // open_side in the piece's UNROTATED frame
};

struct Solver2 {
  Engine2 eng;
  int n;
  int fixed_rows, fixed_cols;
  int numb_puzzles;
  double new_board_compat;

  std::vector<uint8_t> placed;
  std::vector<int> out_row, out_col, out_puzzle, out_rot;  // rot in quarter turns
  std::vector<std::vector<uint8_t>> board;
  int board_dim;
  std::vector<OpenSlot2> open_slots;
  std::vector<int> bb_pool;
  std::vector<uint8_t> in_pool;
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
  long long counter = 0;
  int cur_puzzle = -1;
  int tl_r, tl_c, br_r, br_c;
  int unplaced;

  inline bool occupied(int r, int c) const {
    return board[cur_puzzle][r * board_dim + c] != 0;
  }

  bool slot_open(int r, int c) const {
    if (r < 0 || c < 0 || r >= board_dim || c >= board_dim) return false;
    if (occupied(r, c)) return false;
    if (fixed_rows > 0) {
      if (r - tl_r + 1 > fixed_rows) return false;
      if (br_r - r + 1 > fixed_rows) return false;
      if (c - tl_c + 1 > fixed_cols) return false;
      if (br_c - c + 1 > fixed_cols) return false;
    }
    return true;
  }

  void heap_push(int bb_id, int bb_side, int nb_id, int nb_side, int r, int c) {
    double compat = eng.mc(bb_side, bb_id, nb_side, nb_id);
    heap.push({compat, counter++, bb_id, bb_side, nb_id, nb_side, r, c});
  }

  void add_best_buddies_to_pool(int piece_id) {
    for (int s = 0; s < 4; ++s) {
      long long c = eng.bb[s * n + piece_id];
      if (c < 0) continue;
      int j = (int)(c % n);
      if (placed[j] || in_pool[j]) continue;
      in_pool[j] = 1;
      bb_pool.push_back(j);
      for (const auto& slot : open_slots)
        for (int bb_side = 0; bb_side < 4; ++bb_side)  // type-2: all sides
          heap_push(j, bb_side, slot.piece_id, slot.open_side, slot.row,
                    slot.col);
    }
  }

  void update_open_slots(int piece_id, int r, int c, int rot) {
    const int dr[4] = {-1, 0, 1, 0};   // board sides: top, right, bottom, left
    const int dc[4] = {0, 1, 0, -1};
    for (int side = 0; side < 4; ++side) {
      int nr = r + dr[side], nc = c + dc[side];
      if (!slot_open(nr, nc)) continue;
      // board side -> the piece's unrotated side (puzzle_piece.py:662-685)
      int unrotated = (side + (4 - rot)) % 4;
      open_slots.push_back({nr, nc, piece_id, unrotated});
      for (int pi = 0; pi < (int)bb_pool.size(); ++pi) {
        int bid = bb_pool[pi];
        if (!in_pool[bid]) continue;
        for (int bb_side = 0; bb_side < 4; ++bb_side)
          heap_push(bid, bb_side, piece_id, unrotated, nr, nc);
      }
    }
  }

  void place(int piece_id, int r, int c, int rot, bool from_pool) {
    placed[piece_id] = 1;
    --unplaced;
    out_row[piece_id] = r;
    out_col[piece_id] = c;
    out_rot[piece_id] = rot;
    out_puzzle[piece_id] = cur_puzzle;
    board[cur_puzzle][r * board_dim + c] = 1;
    tl_r = std::min(tl_r, r);
    tl_c = std::min(tl_c, c);
    br_r = std::max(br_r, r);
    br_c = std::max(br_c, c);
    open_slots.erase(
        std::remove_if(open_slots.begin(), open_slots.end(),
                       [&](const OpenSlot2& s) { return s.row == r && s.col == c; }),
        open_slots.end());
    if (from_pool && in_pool[piece_id]) {
      in_pool[piece_id] = 0;
      bb_pool.erase(std::remove(bb_pool.begin(), bb_pool.end(), piece_id),
                    bb_pool.end());
    }
    add_best_buddies_to_pool(piece_id);
    update_open_slots(piece_id, r, c, rot);
  }

  void seed_board() {
    ++cur_puzzle;
    board.emplace_back(board_dim * board_dim, 0);
    int seed = -1;
    for (const auto& t : eng.start_order)
      if (!placed[std::get<0>(t)]) { seed = std::get<0>(t); break; }
    int center = board_dim / 2;
    tl_r = br_r = center;
    tl_c = br_c = center;
    bb_pool.clear();
    std::fill(in_pool.begin(), in_pool.end(), 0);
    while (!heap.empty()) heap.pop();
    open_slots.clear();
    place(seed, center, center, /*rot=*/0, false);
  }

  bool find_next_from_heap(HeapEntry* out) {
    while (!heap.empty()) {
      HeapEntry e = heap.top();
      heap.pop();
      if (!placed[e.bb_id] && slot_open(e.row, e.col)) {
        *out = e;
        return true;
      }
    }
    return false;
  }

  bool find_next_exhaustive(HeapEntry* out) {
    bool found = false;
    double best = -kInf;
    for (const auto& slot : open_slots) {
      if (!slot_open(slot.row, slot.col)) continue;
      for (int next_side = 0; next_side < 4; ++next_side) {
        // first-max over unplaced pieces (np.argmax semantics), then
        // strictly-greater global update (solver._get_next_piece_from_pool)
        int k = -1;
        double kc = -kInf;
        for (int i = 0; i < n; ++i) {
          if (placed[i]) continue;
          double cc = eng.mc(next_side, i, slot.open_side, slot.piece_id);
          if (k < 0 || cc > kc) {
            k = i;
            kc = cc;
          }
        }
        if (k >= 0 && (!found || kc > best)) {
          best = kc;
          *out = {kc, 0, k, next_side, slot.piece_id, slot.open_side,
                  slot.row, slot.col};
          found = true;
        }
      }
    }
    return found;
  }

  void recalc() {
    std::vector<uint8_t> placed_and_open(placed);
    for (const auto& slot : open_slots) placed_and_open[slot.piece_id] = 0;
    eng.recompute(placed.data(), placed_and_open.data());
  }

  int solve(const double* dist, int n_, int fr, int fc, int np_, double nbc,
            int* rows, int* cols, int* pids, int* rots, long long* out_bb) {
    n = n_;
    fixed_rows = fr;
    fixed_cols = fc;
    numb_puzzles = np_;
    new_board_compat = nbc;
    eng.init(dist, n);
    placed.assign(n, 0);
    in_pool.assign(n, 0);
    out_row.assign(n, -1);
    out_col.assign(n, -1);
    out_puzzle.assign(n, -1);
    out_rot.assign(n, 0);
    board_dim = 2 * n + 3;
    unplaced = n;
    cur_puzzle = -1;
    if (out_bb != nullptr)
      for (int idx = 0; idx < 4 * n; ++idx) out_bb[idx] = eng.bb[idx];
    seed_board();

    while (unplaced > 0) {
      HeapEntry e;
      bool have = !bb_pool.empty() && find_next_from_heap(&e);
      bool from_pool = have;
      if (!have) {
        recalc();
        if (!find_next_exhaustive(&e)) return 1;
      }
      if (cur_puzzle + 1 < numb_puzzles && e.compat < new_board_compat) {
        seed_board();
      } else {
        // placed-piece rotation (puzzle_piece.py:630-660): the neighbor's
        // side here is already in its unrotated frame, with rotation 0
        // baked into the slot bookkeeping -> the complementary-side
        // algebra relative to the neighbor's assigned rotation.
        int nrot = out_rot[e.neighbor_id];
        int rot = (nrot + 4 + (e.neighbor_side + 2) % 4 - e.bb_side) % 4;
        // the slot's neighbor_side is the neighbor's UNROTATED side, so
        // the rotated complement must account for the neighbor's rotation
        place(e.bb_id, e.row, e.col, rot, from_pool);
      }
    }

    for (int p = 0; p <= cur_puzzle; ++p) {
      int mr = board_dim, mc2 = board_dim;
      for (int i = 0; i < n; ++i)
        if (out_puzzle[i] == p) {
          mr = std::min(mr, out_row[i]);
          mc2 = std::min(mc2, out_col[i]);
        }
      for (int i = 0; i < n; ++i)
        if (out_puzzle[i] == p) {
          out_row[i] -= mr;
          out_col[i] -= mc2;
        }
    }
    std::memcpy(rows, out_row.data(), n * sizeof(int));
    std::memcpy(cols, out_col.data(), n * sizeof(int));
    std::memcpy(pids, out_puzzle.data(), n * sizeof(int));
    std::memcpy(rots, out_rot.data(), n * sizeof(int));
    return 0;
  }
};

}  // namespace

extern "C" {

// out_bb (nullable): initial best buddies for the BestBuddyAccuracy
// metric; type-1: out_bb[s*n+i] = buddy piece id or -1.
int pt_solve(int n, const double* D, int fixed_rows, int fixed_cols,
             int numb_puzzles, double new_board_compat,
             int* out_rows, int* out_cols, int* out_puzzle_id,
             long long* out_bb) {
  try {
    Solver s;
    return s.solve(D, n, fixed_rows, fixed_cols, numb_puzzles,
                   new_board_compat, out_rows, out_cols, out_puzzle_id,
                   out_bb);
  } catch (...) {
    return 2;
  }
}

// Type-2; out_bb (nullable): out_bb[s*n+i] = flat t*n+j or -1.
int pt_solve2(int n, const double* D, int fixed_rows, int fixed_cols,
              int numb_puzzles, double new_board_compat,
              int* out_rows, int* out_cols, int* out_puzzle_id,
              int* out_rotation, long long* out_bb) {
  try {
    Solver2 s;
    return s.solve(D, n, fixed_rows, fixed_cols, numb_puzzles,
                   new_board_compat, out_rows, out_cols, out_puzzle_id,
                   out_rotation, out_bb);
  } catch (...) {
    return 2;
  }
}

}  // extern "C"
