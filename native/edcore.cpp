// edcore — native host-side builder kernels for dmft_lanc_ed_tpu.
//
// The reference's native substrate is BLAS/LAPACK/P-ARPACK/MPI reached
// through SciFortran; in this framework the device math is XLA and
// the remaining native-code obligation (SURVEY.md §2) is the host-side
// Hilbert-space machinery: basis enumeration, hop-table (ELL) assembly and
// run-length encoding, which sit on the DMFT critical path once per sector
// per solve. These are bit-twiddling + binary-search loops that vectorize
// poorly in numpy for large Ns, so they live here as a small C++ library
// exposed through ctypes (python wrapper: dmft_lanc_ed_tpu/native.py; numpy
// fallback keeps the package importable without the .so).
//
// Build: cc -O3 -march=native -shared -fPIC -o libedcore.so edcore.cpp
// (driven by native/build.sh / the package's lazy builder).

#include <cstdint>
#include <cstring>

extern "C" {

// Enumerate all ns-bit masks with popcount == np, ascending.
// out must hold C(ns, np) entries. Returns the count.
int64_t ed_enumerate_states(int32_t ns, int32_t np, int64_t* out) {
    int64_t count = 0;
    const int64_t limit = int64_t(1) << ns;
    if (np == 0) {
        out[0] = 0;
        return 1;
    }
    // Gosper's hack: next integer with same popcount
    int64_t v = (int64_t(1) << np) - 1;
    while (v < limit) {
        out[count++] = v;
        int64_t t = v | (v - 1);
        v = (t + 1) | (((~t & -~t) - 1) >> (__builtin_ctzll(v) + 1));
    }
    return count;
}

static inline int jw_sign(int64_t state, int pos) {
    int64_t below = state & ((int64_t(1) << pos) - 1);
    return (__builtin_popcountll(below) & 1) ? -1 : 1;
}

static inline int64_t bsearch_state(const int64_t* states, int64_t n,
                                    int64_t key) {
    int64_t lo = 0, hi = n - 1;
    while (lo <= hi) {
        int64_t mid = (lo + hi) / 2;
        if (states[mid] < key) lo = mid + 1;
        else if (states[mid] > key) hi = mid - 1;
        else return mid;
    }
    return -1;
}

// Matrix entries of sum_t amp_t c^+_{c_t} c_{d_t} over a sorted basis.
// Outputs COO triplets (row, col, val); returns nnz. Buffers must hold
// n * nterms entries. Diagonal (c == d) terms are emitted as (i, i, amp).
int64_t ed_hop_entries(const int64_t* states, int64_t n,
                       const int32_t* pos_c, const int32_t* pos_d,
                       const double* amp, int32_t nterms,
                       int64_t* rows, int64_t* cols, double* vals) {
    int64_t nnz = 0;
    for (int32_t t = 0; t < nterms; ++t) {
        const int c = pos_c[t], d = pos_d[t];
        const double a = amp[t];
        if (a == 0.0) continue;
        const int64_t bit_c = int64_t(1) << c;
        const int64_t bit_d = int64_t(1) << d;
        if (c == d) {
            for (int64_t j = 0; j < n; ++j)
                if (states[j] & bit_d) {
                    rows[nnz] = j; cols[nnz] = j; vals[nnz++] = a;
                }
            continue;
        }
        for (int64_t j = 0; j < n; ++j) {
            const int64_t m = states[j];
            if ((m & bit_d) && !(m & bit_c)) {
                const int64_t m1 = m ^ bit_d;
                const int sg = jw_sign(m, d) * jw_sign(m1, c);
                const int64_t m2 = m1 ^ bit_c;
                const int64_t i = bsearch_state(states, n, m2);
                rows[nnz] = i; cols[nnz] = j; vals[nnz++] = a * sg;
            }
        }
    }
    return nnz;
}

// Run-length encode sorted-by-(col) COO entries of one ELL slot into slabs
// (dst0, src0, len, val) with consecutive rows/cols and equal values.
// Returns the number of runs. Buffers sized >= nnz.
int64_t ed_encode_runs(const int64_t* rows, const int64_t* cols,
                       const double* vals, int64_t nnz,
                       int64_t* d0, int64_t* s0, int64_t* len, double* val) {
    if (nnz == 0) return 0;
    int64_t nruns = 0;
    int64_t rd = rows[0], rs = cols[0], L = 1;
    double v = vals[0];
    for (int64_t i = 1; i < nnz; ++i) {
        if (rows[i] == rd + L && cols[i] == rs + L && vals[i] == v) {
            ++L;
        } else {
            d0[nruns] = rd; s0[nruns] = rs; len[nruns] = L; val[nruns] = v;
            ++nruns;
            rd = rows[i]; rs = cols[i]; L = 1; v = vals[i];
        }
    }
    d0[nruns] = rd; s0[nruns] = rs; len[nruns] = L; val[nruns] = v;
    return ++nruns;
}

// Occupation table: bits of each state unpacked to [n, ns] int8.
void ed_occupations(const int64_t* states, int64_t n, int32_t ns,
                    int8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        for (int32_t p = 0; p < ns; ++p)
            out[i * ns + p] = (states[i] >> p) & 1;
}

}  // extern "C"
