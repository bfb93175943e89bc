// Native Turner-2004 evaluator — the CPU oracle's hot path.
//
// Same integer semantics as rafft_tpu/energy/eval_np.py (the tables are
// injected from Python at init, so the calibrated parameter set is the
// single source of truth).  Replaces the role of the reference's
// in-process ViennaRNA C library (rafft/utils.py:135-138) for the
// sequential engine and for device-less environments.
//
// Build: python rafft_tpu/native/build.py   (g++ -O3 -shared -fPIC)

#include <array>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Params {
  // flattened tables (python owns copies; we keep our own)
  std::vector<int32_t> stack;        // [8*8]
  std::vector<int32_t> hairpin;      // [hp_len]
  std::vector<int32_t> bulge;        // [hp_len]
  std::vector<int32_t> internal;     // [hp_len]
  std::vector<int32_t> mmh, mmi, mm1n, mm23, mmm, mmext;  // [8*5*5]
  std::vector<int32_t> d5, d3;       // [8*5]
  std::vector<int32_t> int11;        // [8*8*5*5]
  std::vector<int32_t> int21;        // [8*8*5*5*5]
  std::vector<int32_t> int22;        // [8*8*5*5*5*5]
  std::vector<int32_t> tetra;        // [5^6]
  std::vector<int32_t> tri;          // [5^5]
  std::vector<int32_t> hexa;         // [5^8]
  int32_t hp_len = 0;
  int32_t terminal_au = 0, ml_closing = 0, ml_intern = 0, ml_base = 0;
  int32_t ninio_m = 0, ninio_max = 0;
};

Params P;
const int32_t INT_MISS = INT32_MIN;

// pair type: 0 none, CG=1 GC=2 GU=3 UG=4 AU=5 UA=6 NN=7 (codes A1 C2 G3 U4)
inline int ptype(int a, int b) {
  static const int tbl[5][5] = {
      {0, 0, 0, 0, 0},
      {0, 0, 0, 0, 5},
      {0, 0, 0, 1, 0},
      {0, 0, 2, 0, 3},
      {0, 6, 0, 4, 0}};
  int t = tbl[a][b];
  return t == 0 ? 7 : t;
}

inline int32_t mm(const std::vector<int32_t>& t, int p, int x, int y) {
  return t[(p * 5 + x) * 5 + y];
}

inline int sget(const int8_t* s, int i, int n) {
  return (i >= 0 && i < n) ? s[i] : 0;
}

int32_t hairpin_e(const int8_t* s, int i, int j, int n) {
  int size = j - i - 1;
  int t = ptype(s[i], s[j]);
  int32_t e = P.hairpin[size < P.hp_len ? size : P.hp_len - 1];
  if (size == 4) {
    int key = 0;
    for (int k = i; k <= j; ++k) key = key * 5 + s[k];
    int32_t sp = P.tetra[key];
    if (sp != INT_MISS) return sp;
  } else if (size == 6) {
    int key = 0;
    for (int k = i; k <= j; ++k) key = key * 5 + s[k];
    int32_t sp = P.hexa[key];
    if (sp != INT_MISS) return sp;
  } else if (size == 3) {
    int key = 0;
    for (int k = i; k <= j; ++k) key = key * 5 + s[k];
    int32_t sp = P.tri[key];
    if (sp != INT_MISS) return sp;
    return e + (t > 2 ? P.terminal_au : 0);
  }
  return e + mm(P.mmh, t, s[i + 1], s[j - 1]);
}

int32_t int_loop_e(const int8_t* s, int i, int j, int q, int r) {
  int n1 = q - i - 1, n2 = j - r - 1;
  int t1 = ptype(s[i], s[j]), t2 = ptype(s[r], s[q]);
  int nl = n1 > n2 ? n1 : n2;
  int ns = n1 > n2 ? n2 : n1;
  if (nl == 0) return P.stack[t1 * 8 + t2];
  if (ns == 0) {
    int32_t e = P.bulge[nl < P.hp_len ? nl : P.hp_len - 1];
    if (nl == 1)
      e += P.stack[t1 * 8 + t2];
    else {
      if (t1 > 2) e += P.terminal_au;
      if (t2 > 2) e += P.terminal_au;
    }
    return e;
  }
  int si1 = s[i + 1], sj1 = s[j - 1], sp1 = s[q - 1], sq1 = s[r + 1];
  if (ns == 1) {
    if (nl == 1) return P.int11[((t1 * 8 + t2) * 5 + si1) * 5 + sj1];
    if (nl == 2) {
      if (n1 == 1)
        return P.int21[(((t1 * 8 + t2) * 5 + si1) * 5 + sq1) * 5 + sj1];
      return P.int21[(((t2 * 8 + t1) * 5 + sq1) * 5 + si1) * 5 + sp1];
    }
    int32_t e = P.internal[nl + 1 < P.hp_len ? nl + 1 : P.hp_len - 1];
    int32_t nin = (nl - ns) * P.ninio_m;
    e += nin < P.ninio_max ? nin : P.ninio_max;
    e += mm(P.mm1n, t1, si1, sj1) + mm(P.mm1n, t2, sq1, sp1);
    return e;
  }
  if (ns == 2) {
    if (nl == 2)
      return P.int22[((((t1 * 8 + t2) * 5 + si1) * 5 + sp1) * 5 + sq1) * 5 + sj1];
    if (nl == 3)
      return P.internal[5] + P.ninio_m + mm(P.mm23, t1, si1, sj1) +
             mm(P.mm23, t2, sq1, sp1);
  }
  int32_t e = P.internal[nl + ns < P.hp_len ? nl + ns : P.hp_len - 1];
  int32_t nin = (nl - ns) * P.ninio_m;
  e += nin < P.ninio_max ? nin : P.ninio_max;
  e += mm(P.mmi, t1, si1, sj1) + mm(P.mmi, t2, sq1, sp1);
  return e;
}

inline int32_t ml_stem(const int8_t* s, int n, int t, int i5, int i3) {
  int32_t e = mm(P.mmm, t, sget(s, i5, n), sget(s, i3, n));
  if (t > 2) e += P.terminal_au;
  return e + P.ml_intern;
}

inline int32_t ext_stem(const int8_t* s, int n, int i, int j) {
  int t = ptype(s[i], s[j]);
  int32_t e;
  if (i > 0 && j < n - 1)
    e = mm(P.mmext, t, s[i - 1], s[j + 1]);
  else if (i > 0)
    e = P.d5[t * 5 + s[i - 1]];
  else if (j < n - 1)
    e = P.d3[t * 5 + s[j + 1]];
  else
    e = 0;
  return e + (t > 2 ? P.terminal_au : 0);
}

struct Frame {
  int open;
  int branches;
  int q, r;
  int32_t mlsum;
};

}  // namespace

extern "C" {

void turner_init(const int32_t* stack, const int32_t* hairpin,
                 const int32_t* bulge, const int32_t* internal,
                 int32_t hp_len, const int32_t* mmh, const int32_t* mmi,
                 const int32_t* mm1n, const int32_t* mm23,
                 const int32_t* mmm_, const int32_t* mmext,
                 const int32_t* d5, const int32_t* d3,
                 const int32_t* int11, const int32_t* int21,
                 const int32_t* int22, const int32_t* tetra,
                 const int32_t* tri, const int32_t* hexa,
                 int32_t terminal_au, int32_t ml_closing, int32_t ml_intern,
                 int32_t ml_base, int32_t ninio_m, int32_t ninio_max) {
  auto cp = [](std::vector<int32_t>& dst, const int32_t* src, size_t len) {
    dst.assign(src, src + len);
  };
  cp(P.stack, stack, 64);
  cp(P.hairpin, hairpin, hp_len);
  cp(P.bulge, bulge, hp_len);
  cp(P.internal, internal, hp_len);
  P.hp_len = hp_len;
  cp(P.mmh, mmh, 200);
  cp(P.mmi, mmi, 200);
  cp(P.mm1n, mm1n, 200);
  cp(P.mm23, mm23, 200);
  cp(P.mmm, mmm_, 200);
  cp(P.mmext, mmext, 200);
  cp(P.d5, d5, 40);
  cp(P.d3, d3, 40);
  cp(P.int11, int11, 8 * 8 * 5 * 5);
  cp(P.int21, int21, 8 * 8 * 5 * 5 * 5);
  cp(P.int22, int22, 8 * 8 * 5 * 5 * 5 * 5);
  cp(P.tetra, tetra, 15625);
  cp(P.tri, tri, 3125);
  cp(P.hexa, hexa, 390625);
  P.terminal_au = terminal_au;
  P.ml_closing = ml_closing;
  P.ml_intern = ml_intern;
  P.ml_base = ml_base;
  P.ninio_m = ninio_m;
  P.ninio_max = ninio_max;
}

int32_t turner_eval(const int8_t* codes, const int32_t* pt, int32_t n) {
  int32_t energy = 0;
  std::vector<Frame> st;
  st.reserve(n / 2 + 2);
  st.push_back({-1, 0, 0, 0, 0});  // exterior frame
  for (int k = 0; k < n; ++k) {
    int j = pt[k];
    if (j > k) {
      st.push_back({k, 0, 0, 0, 0});
    } else if (j >= 0 && j < k) {
      Frame f = st.back();
      st.pop_back();
      int i = j;
      int32_t loop_e;
      if (f.branches == 0)
        loop_e = hairpin_e(codes, i, k, n);
      else if (f.branches == 1)
        loop_e = int_loop_e(codes, i, k, f.q, f.r);
      else
        loop_e = P.ml_closing + f.mlsum +
                 ml_stem(codes, n, ptype(codes[k], codes[i]), k - 1, i + 1);
      energy += loop_e;
      Frame& pf = st.back();
      if (pf.open < 0) {
        energy += ext_stem(codes, n, i, k);
      } else {
        pf.mlsum += ml_stem(codes, n, ptype(codes[i], codes[k]), i - 1, k + 1);
      }
      if (pf.branches == 0) {
        pf.q = i;
        pf.r = k;
      }
      pf.branches += 1;
    }
  }
  return energy;
}

void turner_eval_batch(const int8_t* codes, const int32_t* pts, int32_t n,
                       int32_t stride, int32_t count, int32_t* out) {
  for (int b = 0; b < count; ++b)
    out[b] = turner_eval(codes, pts + (size_t)b * stride, n);
}
}

// ======================================================================
// MFE folding (Zuker DP) under the same Turner-2004 / d2-dangle model.
//
// Native replacement for the reference's RNA.fold baseline
// (benchmark_results/src/vrna_mfe.py:24) — the only remaining ViennaRNA
// capability the framework did not yet own.  Recurrences:
//   C(i,j)  = min(hairpin, interior(<=MAXLOOP), ml_close + split(fML,fML))
//   fML     = multiloop segment with >=1 stem (affine ML model)
//   F(j)    = exterior prefix with d2 terminal-mismatch stems
// All arithmetic int32 dekacal -> bit-stable; traceback recomputes
// choices (no backpointer storage), preferring hairpin, then interior
// (p ascending, q descending), then multiloop, mirroring ViennaRNA's
// backtrack order so co-optimal structures usually match too.
// ======================================================================

namespace {

const int32_t MFE_INF = 1 << 28;
const int MAXLOOP = 30;

inline bool canon(int a, int b) {
  static const int tbl[5][5] = {
      {0, 0, 0, 0, 0},
      {0, 0, 0, 0, 1},
      {0, 0, 0, 1, 0},
      {0, 0, 1, 0, 1},
      {0, 1, 0, 1, 0}};
  return tbl[a][b] != 0;
}

inline int32_t ml_stem_ij(const int8_t* s, int n, int i, int j) {
  return ml_stem(s, n, ptype(s[i], s[j]), i - 1, j + 1);
}

struct MfeDP {
  int n;
  const int8_t* s;
  std::vector<int32_t> C, M;  // n*n, row-major [i*n+j]
  std::vector<int32_t> F;     // n+1, F[j] = exterior MFE of s[0..j-1]

  int32_t c(int i, int j) const { return C[(size_t)i * n + j]; }
  int32_t m(int i, int j) const { return M[(size_t)i * n + j]; }

  int32_t interior_best(int i, int j, int* bp = nullptr, int* bq = nullptr) {
    int32_t best = MFE_INF;
    int pmax = i + MAXLOOP + 1;
    if (pmax > j - 5) pmax = j - 5;
    for (int p = i + 1; p <= pmax; ++p) {
      int n1 = p - i - 1;
      int qmin = j - 1 - (MAXLOOP - n1);
      if (qmin < p + 4) qmin = p + 4;
      for (int q = j - 1; q >= qmin; --q) {
        if (!canon(s[p], s[q])) continue;
        int32_t cc = c(p, q);
        if (cc >= MFE_INF) continue;
        int32_t e = int_loop_e(s, i, j, p, q) + cc;
        if (e < best) {
          best = e;
          if (bp) { *bp = p; *bq = q; }
        }
      }
    }
    return best;
  }

  int32_t ml_close_best(int i, int j, int* bu = nullptr) {
    // min over u of fML(i+1,u) + fML(u+1,j-1), plus closing-stem terms
    int32_t best = MFE_INF;
    for (int u = i + 5; u <= j - 6; ++u) {
      int32_t a = m(i + 1, u), b = m(u + 1, j - 1);
      if (a >= MFE_INF || b >= MFE_INF) continue;
      int32_t e = a + b;
      if (e < best) {
        best = e;
        if (bu) *bu = u;
      }
    }
    if (best >= MFE_INF) return MFE_INF;
    return best + P.ml_closing +
           ml_stem(s, n, ptype(s[j], s[i]), j - 1, i + 1);
  }

  void fill() {
    C.assign((size_t)n * n, MFE_INF);
    M.assign((size_t)n * n, MFE_INF);
    for (int i = n - 2; i >= 0; --i) {
      for (int j = i + 4; j < n; ++j) {
        // ---- C
        if (canon(s[i], s[j])) {
          int32_t e = hairpin_e(s, i, j, n);
          int32_t il = interior_best(i, j);
          if (il < e) e = il;
          int32_t ml = ml_close_best(i, j);
          if (ml < e) e = ml;
          C[(size_t)i * n + j] = e;
        }
        // ---- fML
        int32_t e = MFE_INF;
        int32_t v = m(i + 1, j);
        if (v < MFE_INF) e = v + P.ml_base;
        v = m(i, j - 1);
        if (v < MFE_INF && v + P.ml_base < e) e = v + P.ml_base;
        v = c(i, j);
        if (v < MFE_INF) {
          int32_t st = v + ml_stem_ij(s, n, i, j);
          if (st < e) e = st;
        }
        for (int u = i + 4; u <= j - 5; ++u) {
          int32_t a = m(i, u), b = m(u + 1, j);
          if (a < MFE_INF && b < MFE_INF && a + b < e) e = a + b;
        }
        M[(size_t)i * n + j] = e;
      }
    }
    F.assign(n + 1, 0);
    for (int j = 4; j < n; ++j) {
      int32_t best = F[j];  // j unpaired (F indexed by position: F[j] uses 0..j)
      for (int i = 0; i <= j - 4; ++i) {
        int32_t cc = c(i, j);
        if (cc >= MFE_INF) continue;
        int32_t e = (i > 0 ? F[i] : 0) + cc + ext_stem(s, n, i, j);
        if (e < best) best = e;
      }
      F[j + 1] = best;
    }
    // F[k] = MFE of prefix s[0..k-1]; F[0]=F[1..4]=0 handled by init+loop
    for (int j = 1; j <= 4 && j <= n; ++j) F[j] = 0;
  }

  void traceback(int32_t* pt) {
    for (int k = 0; k < n; ++k) pt[k] = -1;
    std::vector<std::array<int, 3>> stk;  // {kind: 0=F,1=C,2=M, i, j}
    stk.push_back({0, 0, n - 1});
    while (!stk.empty()) {
      auto [kind, i, j] = stk.back();
      stk.pop_back();
      if (kind == 0) {
        // exterior segment [0..j]
        int jj = j;
        while (jj >= 4) {
          if (F[jj + 1] == F[jj]) { --jj; continue; }
          bool found = false;
          for (int i2 = 0; i2 <= jj - 4; ++i2) {
            int32_t cc = c(i2, jj);
            if (cc >= MFE_INF) continue;
            if ((i2 > 0 ? F[i2] : 0) + cc + ext_stem(s, n, i2, jj) ==
                F[jj + 1]) {
              pt[i2] = jj;
              pt[jj] = i2;
              stk.push_back({1, i2, jj});
              jj = i2 - 1;
              found = true;
              break;
            }
          }
          if (!found) --jj;  // defensive: should not happen
        }
      } else if (kind == 1) {
        int32_t target = c(i, j);
        if (target == hairpin_e(s, i, j, n)) continue;
        int bp = -1, bq = -1;
        int32_t il = interior_best(i, j, &bp, &bq);
        if (il == target) {
          pt[bp] = bq;
          pt[bq] = bp;
          stk.push_back({1, bp, bq});
          continue;
        }
        int bu = -1;
        if (ml_close_best(i, j, &bu) == target && bu >= 0) {
          stk.push_back({2, i + 1, bu});
          stk.push_back({2, bu + 1, j - 1});
        }
      } else {
        // multiloop segment
        int ii = i, jj = j;
        while (ii < jj) {
          int32_t target = m(ii, jj);
          if (target >= MFE_INF) break;
          if (ii + 1 <= jj && m(ii + 1, jj) < MFE_INF &&
              target == m(ii + 1, jj) + P.ml_base) { ++ii; continue; }
          if (jj - 1 >= ii && m(ii, jj - 1) < MFE_INF &&
              target == m(ii, jj - 1) + P.ml_base) { --jj; continue; }
          if (c(ii, jj) < MFE_INF &&
              target == c(ii, jj) + ml_stem_ij(s, n, ii, jj)) {
            pt[ii] = jj;
            pt[jj] = ii;
            stk.push_back({1, ii, jj});
            break;
          }
          bool split = false;
          for (int u = ii + 4; u <= jj - 5; ++u) {
            if (m(ii, u) < MFE_INF && m(u + 1, jj) < MFE_INF &&
                target == m(ii, u) + m(u + 1, jj)) {
              stk.push_back({2, ii, u});
              ii = u + 1;
              split = true;
              break;
            }
          }
          if (!split) break;  // defensive
        }
      }
    }
  }
};

}  // namespace

extern "C" {

int32_t turner_mfe(const int8_t* codes, int32_t n, int32_t* pt_out) {
  if (n < 5) {
    for (int k = 0; k < n; ++k) pt_out[k] = -1;
    return 0;
  }
  MfeDP dp;
  dp.n = n;
  dp.s = codes;
  dp.fill();
  dp.traceback(pt_out);
  return dp.F[n];
}
}
