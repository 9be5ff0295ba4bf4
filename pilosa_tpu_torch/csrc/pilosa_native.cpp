// Host-side roaring kernels of the port: the host fold's C++ passes
// (popcount of {s, s&m, s|m, s^m, s&~m} word runs, per-container
// popcounts, the fused flat fold with per-container counts) and the
// sorted-array container ops. A copy of the JAX package's
// native/pilosa_native.cpp: the same 14 extern "C" functions, the same
// names and semantics.
//
// Host C++, not CUDA: pilosa_tpu_torch.ops.native builds it with g++
// at its first call into csrc/_build/ and loads it with ctypes
// (RTLD_LOCAL, so the JAX package's library of the same symbols can sit
// in the same process).
//
// Bitmap kernels work on 64-bit words (a bitmap container is 1024 words,
// a row's 16 containers one 16,384-word block); array kernels on sorted
// unique uint32 values.

#include <cstddef>
#include <cstdint>

#if defined(__GNUC__)
#define POPCNT64(x) __builtin_popcountll(x)
#define CTZ64(x) __builtin_ctzll(x)
#else
static inline int POPCNT64(uint64_t x) {
  int n = 0;
  while (x) { x &= x - 1; ++n; }
  return n;
}
static inline int CTZ64(uint64_t x) {
  int n = 0;
  while (!(x & 1)) { x >>= 1; ++n; }
  return n;
}
#endif

extern "C" {

// ---- fused popcounts of word runs ------------------------------------------

uint64_t pilosa_popcnt_slice(const uint64_t* s, size_t n) {
  uint64_t total = 0;
  for (size_t i = 0; i < n; ++i) total += POPCNT64(s[i]);
  return total;
}

uint64_t pilosa_popcnt_and_slice(const uint64_t* s, const uint64_t* m,
                                 size_t n) {
  uint64_t total = 0;
  for (size_t i = 0; i < n; ++i) total += POPCNT64(s[i] & m[i]);
  return total;
}

uint64_t pilosa_popcnt_or_slice(const uint64_t* s, const uint64_t* m,
                                size_t n) {
  uint64_t total = 0;
  for (size_t i = 0; i < n; ++i) total += POPCNT64(s[i] | m[i]);
  return total;
}

uint64_t pilosa_popcnt_xor_slice(const uint64_t* s, const uint64_t* m,
                                 size_t n) {
  uint64_t total = 0;
  for (size_t i = 0; i < n; ++i) total += POPCNT64(s[i] ^ m[i]);
  return total;
}

uint64_t pilosa_popcnt_andnot_slice(const uint64_t* s, const uint64_t* m,
                                    size_t n) {
  uint64_t total = 0;
  for (size_t i = 0; i < n; ++i) total += POPCNT64(s[i] & ~m[i]);
  return total;
}

// Per-block popcounts in one pass: out[b] = popcount(s[b*bwords ..
// (b+1)*bwords)). HostMaterializePlan needs one count per roaring
// container (1024 words) to pick the array or bitmap form and to fill
// the Row's per-slice count cache; a scalar popcount per container would
// pay the ctypes call 16 times a slice.
void pilosa_popcnt_blocks(const uint64_t* s, size_t nblocks, size_t bwords,
                          uint64_t* out) {
  for (size_t b = 0; b < nblocks; ++b) {
    uint64_t total = 0;
    const uint64_t* p = s + b * bwords;
    for (size_t i = 0; i < bwords; ++i) total += POPCNT64(p[i]);
    out[b] = total;
  }
}

// Fused flat left fold + per-block popcount, one pass: out[i] =
// leaves[0][i] op leaves[1][i] op ..., counts[b] = popcount of block b
// of out. The host fold's hot loop (HostCountPlan, HostMaterializePlan):
// a numpy fold and a separate count pass would read the result once
// more; this counts each block while it is in L1. op: 0=and, 1=or,
// 2=andnot (ops/bitops.fold_tree's left-fold semantics).
// Two loops per block, ON PURPOSE: the fold loop carries no popcount
// so the compiler auto-vectorizes it; the count loop then re-reads the
// 8 KB block while it is still in L1 (vs a separate whole-result count
// pass that re-streams 100+ MB from memory).
#define FOLD_LOOP(OPEXPR)                                              \
  for (size_t b = 0; b < nblocks; ++b) {                               \
    const size_t off = b * bwords;                                     \
    uint64_t* ob = out + off;                                          \
    for (size_t i = 0; i < bwords; ++i) {                              \
      uint64_t acc = leaves[0][off + i];                               \
      for (size_t l = 1; l < nleaves; ++l) {                           \
        const uint64_t w = leaves[l][off + i];                         \
        acc = (OPEXPR);                                                \
      }                                                                \
      ob[i] = acc;                                                     \
    }                                                                  \
    uint64_t cnt = 0;                                                  \
    for (size_t i = 0; i < bwords; ++i) cnt += POPCNT64(ob[i]);        \
    counts[b] = cnt;                                                   \
  }

// Two-leaf specialization: the runtime `nleaves` loop above defeats
// auto-vectorization; with two fixed pointers the fold loop compiles
// to plain SIMD and/or/andn. Two leaves is the common shape (the
// headline Count(Intersect(Bitmap, Bitmap)), most Differences).
#define FOLD2_LOOP(OPEXPR)                                             \
  for (size_t b = 0; b < nblocks; ++b) {                               \
    const size_t off = b * bwords;                                     \
    const uint64_t* pa = a + off;                                      \
    const uint64_t* pb = bb + off;                                     \
    uint64_t* ob = out + off;                                          \
    for (size_t i = 0; i < bwords; ++i) ob[i] = (OPEXPR);              \
    uint64_t cnt = 0;                                                  \
    for (size_t i = 0; i < bwords; ++i) cnt += POPCNT64(ob[i]);        \
    counts[b] = cnt;                                                   \
  }

static void fold2_blocks(const uint64_t* a, const uint64_t* bb, int op,
                         size_t nblocks, size_t bwords, uint64_t* out,
                         uint64_t* counts) {
  if (op == 0) {
    FOLD2_LOOP(pa[i] & pb[i])
  } else if (op == 1) {
    FOLD2_LOOP(pa[i] | pb[i])
  } else {
    FOLD2_LOOP(pa[i] & ~pb[i])
  }
}
#undef FOLD2_LOOP

void pilosa_fold_blocks(const uint64_t** leaves, size_t nleaves, int op,
                        size_t nblocks, size_t bwords, uint64_t* out,
                        uint64_t* counts) {
  if (nleaves == 2) {
    fold2_blocks(leaves[0], leaves[1], op, nblocks, bwords, out, counts);
    return;
  }
  if (op == 0) {
    FOLD_LOOP(acc & w)
  } else if (op == 1) {
    FOLD_LOOP(acc | w)
  } else {
    FOLD_LOOP(acc & ~w)
  }
}
#undef FOLD_LOOP

// ---- sorted-array container kernels -------------------------------------------
// Inputs are sorted unique; outputs are sorted unique. `out` must have
// room for the worst case (na, na+nb, na, na+nb respectively).

size_t pilosa_intersect_sorted_u32(const uint32_t* a, size_t na,
                                   const uint32_t* b, size_t nb,
                                   uint32_t* out) {
  size_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) ++i;
    else if (a[i] > b[j]) ++j;
    else { out[k++] = a[i]; ++i; ++j; }
  }
  return k;
}

size_t pilosa_intersection_count_sorted_u32(const uint32_t* a, size_t na,
                                            const uint32_t* b, size_t nb) {
  size_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) ++i;
    else if (a[i] > b[j]) ++j;
    else { ++k; ++i; ++j; }
  }
  return k;
}

size_t pilosa_union_sorted_u32(const uint32_t* a, size_t na,
                               const uint32_t* b, size_t nb, uint32_t* out) {
  size_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) out[k++] = a[i++];
    else if (a[i] > b[j]) out[k++] = b[j++];
    else { out[k++] = a[i]; ++i; ++j; }
  }
  while (i < na) out[k++] = a[i++];
  while (j < nb) out[k++] = b[j++];
  return k;
}

size_t pilosa_difference_sorted_u32(const uint32_t* a, size_t na,
                                    const uint32_t* b, size_t nb,
                                    uint32_t* out) {
  size_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) out[k++] = a[i++];
    else if (a[i] > b[j]) ++j;
    else { ++i; ++j; }
  }
  while (i < na) out[k++] = a[i++];
  return k;
}

size_t pilosa_xor_sorted_u32(const uint32_t* a, size_t na,
                             const uint32_t* b, size_t nb, uint32_t* out) {
  size_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) out[k++] = a[i++];
    else if (a[i] > b[j]) out[k++] = b[j++];
    else { ++i; ++j; }
  }
  while (i < na) out[k++] = a[i++];
  while (j < nb) out[k++] = b[j++];
  return k;
}

// ---- bitmap <-> values (trailing-zero scan) -----------------------------------

size_t pilosa_bitmap_to_values_u32(const uint64_t* words, size_t n_words,
                                   uint32_t* out) {
  size_t k = 0;
  for (size_t w = 0; w < n_words; ++w) {
    uint64_t word = words[w];
    uint32_t base = (uint32_t)(w << 6);
    while (word) {
      out[k++] = base + (uint32_t)CTZ64(word);
      word &= word - 1;
    }
  }
  return k;
}

// Membership test of sorted values against a bitmap: out_mask[i] = 1 if
// bit a[i] set. Used by array x bitmap intersect and difference.
void pilosa_bitmap_contains_u32(const uint64_t* words, const uint32_t* a,
                                size_t na, uint8_t* out_mask) {
  for (size_t i = 0; i < na; ++i) {
    out_mask[i] = (uint8_t)((words[a[i] >> 6] >> (a[i] & 63)) & 1);
  }
}

}  // extern "C"
