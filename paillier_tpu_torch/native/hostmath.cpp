// Native host-math runtime for paillier_tpu.
//
// The reference implementation does ALL of its big-integer arithmetic
// through libgmp via CGo (github.com/ncw/gmp, imported at
// reference paillier.go:10).  In the TPU framework the *data plane*
// (batched encrypt/decrypt/proof math) lives on device, but the
// *control plane* — key generation primality testing, safe-prime search
// (reference safe_prime.go:61-266), modular inverses for Lagrange
// combining (reference thresholdkey.go:132-138) — is host-side latency
// work where a native big-int library wins by an order of magnitude
// over Python ints.
//
// This file is that native runtime: a thin, exception-free C ABI over
// the system GMP shared library.  No GMP headers are required — the
// mpz ABI (struct layout + __gmpz_* entry points) has been stable for
// decades and is declared locally below.  All values cross the
// boundary as fixed-length big-endian byte buffers.
//
// Build (see paillier_tpu/native/__init__.py, which does this lazily):
//   g++ -O2 -shared -fPIC -std=c++17 hostmath.cpp \
//       /usr/lib/x86_64-linux-gnu/libgmp.so.10 -lpthread -o _hostmath.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// GMP ABI (subset), declared locally.  Layouts match gmp.h on LP64.
// ---------------------------------------------------------------------------

typedef unsigned long mp_limb_t;

struct __mpz_struct {
  int _mp_alloc;
  int _mp_size;
  mp_limb_t *_mp_d;
};
typedef __mpz_struct mpz_t[1];

extern "C" {
void __gmpz_init(mpz_t);
void __gmpz_clear(mpz_t);
void __gmpz_set_ui(mpz_t, unsigned long);
void __gmpz_set(mpz_t, const mpz_t);
void __gmpz_import(mpz_t, size_t, int, size_t, int, size_t, const void *);
void *__gmpz_export(void *, size_t *, int, size_t, int, size_t, const mpz_t);
void __gmpz_powm(mpz_t, const mpz_t, const mpz_t, const mpz_t);
int __gmpz_probab_prime_p(const mpz_t, int);
int __gmpz_invert(mpz_t, const mpz_t, const mpz_t);
void __gmpz_gcd(mpz_t, const mpz_t, const mpz_t);
void __gmpz_mul(mpz_t, const mpz_t, const mpz_t);
void __gmpz_mod(mpz_t, const mpz_t, const mpz_t);
void __gmpz_add_ui(mpz_t, const mpz_t, unsigned long);
void __gmpz_sub_ui(mpz_t, const mpz_t, unsigned long);
void __gmpz_mul_2exp(mpz_t, const mpz_t, unsigned long);
unsigned long __gmpz_fdiv_ui(const mpz_t, unsigned long);
size_t __gmpz_sizeinbase(const mpz_t, int);
int __gmpz_cmp_ui(const mpz_t, unsigned long);
}

// ---------------------------------------------------------------------------
// Byte-buffer <-> mpz helpers (big-endian, fixed width on export)
// ---------------------------------------------------------------------------

static void import_be(mpz_t z, const uint8_t *buf, size_t len) {
  __gmpz_import(z, len, 1, 1, 1, 0, buf);
}

// Returns 0 on success, -1 if z does not fit outlen bytes (out is zeroed;
// never writes past the buffer — see ADVICE r1 on the old clamping code).
static int export_be(uint8_t *out, size_t outlen, const mpz_t z) {
  std::memset(out, 0, outlen);
  if (__gmpz_cmp_ui(z, 0) == 0) return 0;
  size_t nbytes = (__gmpz_sizeinbase(z, 2) + 7) / 8;
  if (nbytes > outlen) return -1;
  __gmpz_export(out + (outlen - nbytes), nullptr, 1, 1, 1, 0, z);
  return 0;
}

// ---------------------------------------------------------------------------
// Exported C API
// ---------------------------------------------------------------------------

extern "C" {

int pt_abi_version() { return 2; }

// out[ml] = (b^e) mod m.  Returns 0 on success, -1 on zero modulus.
int pt_powm(const uint8_t *b, size_t bl, const uint8_t *e, size_t el,
            const uint8_t *m, size_t ml, uint8_t *out) {
  mpz_t zb, ze, zm, zr;
  __gmpz_init(zb);
  __gmpz_init(ze);
  __gmpz_init(zm);
  __gmpz_init(zr);
  import_be(zb, b, bl);
  import_be(ze, e, el);
  import_be(zm, m, ml);
  int rc = -1;
  if (__gmpz_cmp_ui(zm, 0) != 0) {
    __gmpz_powm(zr, zb, ze, zm);
    rc = export_be(out, ml, zr);
  }
  __gmpz_clear(zb);
  __gmpz_clear(ze);
  __gmpz_clear(zm);
  __gmpz_clear(zr);
  return rc;
}

// Batched shared-exponent/modulus powm across n bases (each stride bytes),
// parallelized over threads.  Used for host-side verification sweeps.
int pt_powm_batch(const uint8_t *bases, size_t n, size_t stride,
                  const uint8_t *e, size_t el, const uint8_t *m, size_t ml,
                  uint8_t *out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  {  // reject zero modulus once up front (GMP powm would SIGFPE)
    mpz_t zm;
    __gmpz_init(zm);
    import_be(zm, m, ml);
    int zero = __gmpz_cmp_ui(zm, 0) == 0;
    __gmpz_clear(zm);
    if (zero) return -1;
  }
  std::atomic<size_t> next(0);
  auto worker = [&]() {
    mpz_t zb, ze, zm, zr;
    __gmpz_init(zb);
    __gmpz_init(ze);
    __gmpz_init(zm);
    __gmpz_init(zr);
    import_be(ze, e, el);
    import_be(zm, m, ml);
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n) break;
      import_be(zb, bases + i * stride, stride);
      __gmpz_powm(zr, zb, ze, zm);
      export_be(out + i * ml, ml, zr);
    }
    __gmpz_clear(zb);
    __gmpz_clear(ze);
    __gmpz_clear(zm);
    __gmpz_clear(zr);
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < n_threads; ++t) ts.emplace_back(worker);
  worker();
  for (auto &t : ts) t.join();
  return 0;
}

// 2 = definitely prime, 1 = probably prime, 0 = composite (GMP semantics:
// Baillie-PSW + reps Miller-Rabin rounds; cf. Go ProbablyPrime(20) used at
// reference safe_prime.go:256).
int pt_probab_prime(const uint8_t *x, size_t xl, int reps) {
  mpz_t z;
  __gmpz_init(z);
  import_be(z, x, xl);
  int r = __gmpz_probab_prime_p(z, reps);
  __gmpz_clear(z);
  return r;
}

// out[ml] = a^{-1} mod m; returns 1 if invertible, 0 if not, -1 on a
// zero modulus (GMP invert with |m| == 0 divides by zero).
int pt_invert(const uint8_t *a, size_t al, const uint8_t *m, size_t ml,
              uint8_t *out) {
  mpz_t za, zm, zr;
  __gmpz_init(za);
  __gmpz_init(zm);
  __gmpz_init(zr);
  import_be(za, a, al);
  import_be(zm, m, ml);
  int ok = -1;
  if (__gmpz_cmp_ui(zm, 0) != 0) {
    ok = __gmpz_invert(zr, za, zm);
    if (ok && export_be(out, ml, zr) != 0) ok = -1;
  }
  __gmpz_clear(za);
  __gmpz_clear(zm);
  __gmpz_clear(zr);
  return ok;
}

// out[outl] = gcd(a, b).  Returns 0 on success, -1 if it doesn't fit.
int pt_gcd(const uint8_t *a, size_t al, const uint8_t *b, size_t bl,
           uint8_t *out, size_t outl) {
  mpz_t za, zb, zr;
  __gmpz_init(za);
  __gmpz_init(zb);
  __gmpz_init(zr);
  import_be(za, a, al);
  import_be(zb, b, bl);
  __gmpz_gcd(zr, za, zb);
  int rc = export_be(out, outl, zr);
  __gmpz_clear(za);
  __gmpz_clear(zb);
  __gmpz_clear(zr);
  return rc;
}

// out[ml] = (a * b) mod m.  Returns 0 on success, -1 on zero modulus.
int pt_mulmod(const uint8_t *a, size_t al, const uint8_t *b, size_t bl,
              const uint8_t *m, size_t ml, uint8_t *out) {
  mpz_t za, zb, zm;
  __gmpz_init(za);
  __gmpz_init(zb);
  __gmpz_init(zm);
  import_be(za, a, al);
  import_be(zb, b, bl);
  import_be(zm, m, ml);
  int rc = -1;
  if (__gmpz_cmp_ui(zm, 0) != 0) {
    __gmpz_mul(za, za, zb);
    __gmpz_mod(za, za, zm);
    rc = export_be(out, ml, za);
  }
  __gmpz_clear(za);
  __gmpz_clear(zb);
  __gmpz_clear(zm);
  return rc;
}

// Batched modular inverse: out[i*ml..] = a_i^{-1} mod m.  Returns the
// number of non-invertible elements (their outputs are zeroed), or -1 on
// a zero modulus.  Used for the per-proof inverse batches in
// DDLEQ/threshold combining (reference computes these one ModInverse at
// a time, ddleq.go:96, thresholdkey.go:132).
//
// Each thread runs Montgomery's batch-inversion trick on a contiguous
// chunk: ONE mpz_invert plus 3*(chunk-1) modular multiplies replaces
// chunk mpz_inverts — ~8x fewer host cycles at 4096-bit moduli (r5;
// the per-element loop held the threshold flow's host stage at ~110 ms
// per 4096-batch).  If a chunk's total product is not invertible (some
// element shares a factor with m), that chunk alone falls back to the
// per-element path to identify and zero the bad entries.
long pt_modinv_batch(const uint8_t *as, size_t n, size_t stride,
                     const uint8_t *m, size_t ml, uint8_t *out,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if ((size_t)n_threads > n) n_threads = (int)(n ? n : 1);
  {
    mpz_t zm;
    __gmpz_init(zm);
    import_be(zm, m, ml);
    int zero = __gmpz_cmp_ui(zm, 0) == 0;
    __gmpz_clear(zm);
    if (zero) return -1;
  }
  std::atomic<long> bad(0);
  auto worker = [&](size_t lo, size_t hi) {
    size_t cnt = hi - lo;
    if (cnt == 0) return;
    mpz_t zm, za, inv, t;
    __gmpz_init(zm);
    __gmpz_init(za);
    __gmpz_init(inv);
    __gmpz_init(t);
    import_be(zm, m, ml);
    // prefix[j] = a_lo * ... * a_{lo+j} mod m  (mpz_t is an array type,
    // so the vector holds the underlying structs)
    std::vector<__mpz_struct> pre(cnt);
    for (size_t j = 0; j < cnt; ++j) __gmpz_init(&pre[j]);
    import_be(&pre[0], as + lo * stride, stride);
    __gmpz_mod(&pre[0], &pre[0], zm);
    for (size_t j = 1; j < cnt; ++j) {
      import_be(za, as + (lo + j) * stride, stride);
      __gmpz_mul(t, &pre[j - 1], za);
      __gmpz_mod(&pre[j], t, zm);
    }
    if (__gmpz_invert(inv, &pre[cnt - 1], zm)) {
      // unwind: out_j = inv_running * prefix[j-1]; inv_running *= a_j
      for (size_t j = cnt; j-- > 0;) {
        if (j > 0) {
          __gmpz_mul(t, inv, &pre[j - 1]);
          __gmpz_mod(t, t, zm);
          export_be(out + (lo + j) * ml, ml, t);
        } else {
          export_be(out + lo * ml, ml, inv);
        }
        import_be(za, as + (lo + j) * stride, stride);
        __gmpz_mul(t, inv, za);
        __gmpz_mod(inv, t, zm);
      }
    } else {
      // rare: some element not invertible — per-element fallback
      for (size_t j = 0; j < cnt; ++j) {
        import_be(za, as + (lo + j) * stride, stride);
        if (__gmpz_invert(t, za, zm)) {
          export_be(out + (lo + j) * ml, ml, t);
        } else {
          std::memset(out + (lo + j) * ml, 0, ml);
          bad.fetch_add(1);
        }
      }
    }
    for (size_t j = 0; j < cnt; ++j) __gmpz_clear(&pre[j]);
    __gmpz_clear(zm);
    __gmpz_clear(za);
    __gmpz_clear(inv);
    __gmpz_clear(t);
  };
  std::vector<std::thread> ts;
  size_t per = (n + n_threads - 1) / n_threads;
  for (int tix = 1; tix < n_threads; ++tix) {
    size_t lo = (size_t)tix * per;
    size_t hi = lo + per < n ? lo + per : n;
    if (lo < hi) ts.emplace_back(worker, lo, hi);
  }
  worker(0, per < n ? per : n);
  for (auto &th : ts) th.join();
  return bad.load();
}

// ---------------------------------------------------------------------------
// Batch prime filtering (reference safe_prime.go:61-266).  The caller draws
// full-entropy candidates from its own CSPRNG (the reference reads
// crypto/rand per candidate, safe_prime.go:175) and this runtime only
// *tests* them — sieve, Miller-Rabin/BPSW, and for safe primes the
// q != 1 (mod 3) filter (safe_prime.go:225-241) plus Fermat base-2 on
// p = 2q + 1 (Pocklington, safe_prime.go:272-278).  The reference's
// goroutine race becomes a deterministic std::thread race: threads claim
// batch indices in order and the LOWEST passing index wins, so the result
// depends only on the candidate list, never on scheduling or thread count.
// ---------------------------------------------------------------------------

static const unsigned kSieve[] = {3,  5,  7,  11, 13, 17, 19, 23,
                                  29, 31, 37, 41, 43, 47, 53};

// Scan `count` big-endian `width`-byte candidates; return the lowest index
// that passes, or -1 if none.  mode 0: plain probable prime (`reps` MR
// rounds on top of BPSW).  mode 1: safe-prime q test (sieve on q and
// 2q+1, q % 3 != 1, q probable prime, Fermat base-2 on 2q+1).
long pt_first_prime(const uint8_t *cands, size_t count, size_t width,
                    int reps, int mode, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<size_t> next(0);
  std::atomic<long> best(-1);
  auto worker = [&]() {
    mpz_t q, p, pm1, two, t;
    __gmpz_init(q);
    __gmpz_init(p);
    __gmpz_init(pm1);
    __gmpz_init(two);
    __gmpz_init(t);
    __gmpz_set_ui(two, 2);
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= count) break;
      long b = best.load(std::memory_order_relaxed);
      if (b >= 0 && (size_t)b < i) break;  // a lower index already won
      import_be(q, cands + i * width, width);
      bool ok;
      if (mode == 0) {
        ok = __gmpz_probab_prime_p(q, reps) > 0;
      } else {
        ok = true;
        size_t qbits = __gmpz_sizeinbase(q, 2);
        if (qbits > 6) {
          for (unsigned sp : kSieve) {
            unsigned long r = __gmpz_fdiv_ui(q, sp);
            if (r == 0 || (2 * r + 1) % sp == 0) {
              ok = false;
              break;
            }
          }
          if (ok && __gmpz_fdiv_ui(q, 3) == 1) ok = false;
        }
        if (ok) ok = __gmpz_probab_prime_p(q, reps) > 0;
        if (ok) {
          // p = 2q + 1; Fermat base 2 proves p prime given q prime
          __gmpz_mul_2exp(p, q, 1);
          __gmpz_add_ui(p, p, 1);
          __gmpz_sub_ui(pm1, p, 1);
          __gmpz_powm(t, two, pm1, p);
          ok = __gmpz_cmp_ui(t, 1) == 0;
        }
      }
      if (ok) {
        long cur = best.load(std::memory_order_relaxed);
        long mine = (long)i;
        while ((cur < 0 || mine < cur) &&
               !best.compare_exchange_weak(cur, mine)) {
        }
      }
    }
    __gmpz_clear(q);
    __gmpz_clear(p);
    __gmpz_clear(pm1);
    __gmpz_clear(two);
    __gmpz_clear(t);
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < n_threads; ++t) ts.emplace_back(worker);
  worker();
  for (auto &th : ts) th.join();
  return best.load();
}

}  // extern "C"
