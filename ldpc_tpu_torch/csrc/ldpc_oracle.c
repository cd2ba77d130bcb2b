/* Native fixed-point LDPC decoder oracle of the PyTorch/CUDA port.
 *
 * A copy of csrc/ldpc_oracle.c, the sequential fixed-point min-sum /
 * offset-min-sum / min* message-passing loop in C: a fast bit-exact witness
 * for cross-checks of the torch decoders and the CUDA kernels at sizes the
 * NumPy golden model is too slow for. The message-passing code is the
 * original's, untouched, so that it stays independent of the torch code.
 * Two things differ: nothing here calls abort(), and both entry points
 * return a status (ORACLE_OK, ORACLE_ERR_NOMEM when a scratch allocation
 * fails, ORACLE_ERR_DEGREE when min* meets a check of degree > 64, which its
 * fixed stack buffers cannot hold) that ldpc_tpu_torch/oracle.py turns into
 * an exception, so that a bad graph cannot kill the calling process.
 *
 * Semantics are pinned by ldpc_tpu_torch/golden/decoder.py and must match it
 * EXACTLY (integer min-sum is deterministic; tests assert equality):
 *   - v2c = clip(total_or_posterior - c2v_old, -qmax, +qmax)
 *   - CN: sign-product x (min1/min2 exclude-self, stable first-min ties),
 *     offset beta, floor 0, cap qmax
 *   - sign(0) = +1; exact wide-integer posterior accumulation
 *   - hard bit = 1 iff posterior < 0; per-codeword early termination
 *   - flooding: all checks read the iteration-start totals
 *   - layered: layers in order; all checks of a layer read the pre-layer
 *     posterior (guaranteed: a layer touches each variable at most once)
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define CLIP(x, lo, hi) ((x) < (lo) ? (lo) : ((x) > (hi) ? (hi) : (x)))

#define ORACLE_OK 0
#define ORACLE_ERR_NOMEM 1
#define ORACLE_ERR_DEGREE 2

/* CN update for one check: incoming v2c[deg] -> outgoing c2v[deg].
 * Matches golden _cn_update including degree-1 (empty exclude-min = qmax).
 * anum/ashift: normalized-min-sum dyadic scaling applied to the magnitude
 * before the beta offset (golden _mag_xform); (1, 0) is the identity. */
static void cn_update(const int32_t *v2c, int deg, int beta, int qmax,
                      int anum, int ashift, int32_t *out) {
    if (deg == 1) {
        int32_t mag = ((qmax * anum) >> ashift) - beta;
        out[0] = mag > 0 ? mag : 0;
        return;
    }
    int32_t min1 = INT32_MAX, min2 = INT32_MAX;
    int amin = 0, neg = 0;
    for (int t = 0; t < deg; t++) {
        int32_t v = v2c[t];
        int32_t a = v < 0 ? -v : v;
        if (v < 0) neg ^= 1;
        if (a < min1) { min2 = min1; min1 = a; amin = t; }
        else if (a < min2) { min2 = a; }
    }
    /* scale in 64-bit so min2 == INT32_MAX (impossible for deg >= 2 after
     * the loop, but keep it defined) cannot overflow */
    int32_t m1 = (int32_t)(((int64_t)min1 * anum) >> ashift) - beta;
    int32_t m2 = (int32_t)(((int64_t)min2 * anum) >> ashift) - beta;
    if (m1 < 0) m1 = 0;
    if (m2 < 0) m2 = 0;
    if (m1 > qmax) m1 = qmax;
    if (m2 > qmax) m2 = qmax;
    for (int t = 0; t < deg; t++) {
        int32_t mag = (t == amin) ? m2 : m1;
        int s = neg ^ (v2c[t] < 0);
        out[t] = s ? -mag : mag;
    }
}

/* Pinned fixed-point pairwise box-plus (min* CN arithmetic) — exact
 * mirror of golden _boxplus2: per-combine clip to [0, qmax], threshold-
 * LUT correction (one LSB per crossed threshold), sign(0) = +1, +INF
 * sentinel identity. */
#define MS_INF (1 << 14)
static int32_t bp2(int32_t x, int32_t y, const int32_t *T, int nT,
                   int qmax) {
    int32_t ax = x < 0 ? -x : x, ay = y < 0 ? -y : y;
    int32_t mn = ax < ay ? ax : ay;
    int32_t sm = ax + ay, df = ax - ay;
    if (df < 0) df = -df;
    int32_t c = 0;
    for (int i = 0; i < nT; i++) {
        if (sm <= T[i]) c++;
        if (df <= T[i]) c--;
    }
    int32_t mag = mn + c;
    if (mag < 0) mag = 0;
    if (mag > qmax) mag = qmax;
    return ((x < 0) != (y < 0)) ? -mag : mag;
}

/* min* CN update: exclude-self box-plus by prefix/suffix combines in
 * neighbor order (golden _cn_update_minstar; the per-combine clip makes
 * evaluation order part of the semantics). deg < 64 everywhere in this
 * repo's code families. */
static void cn_update_minstar(const int32_t *v2c, int deg, int qmax,
                              const int32_t *T, int nT, int32_t *out) {
    int32_t pre[65], suf[65];
    pre[0] = MS_INF;
    suf[deg] = MS_INF;
    for (int i = 0; i < deg; i++) {
        pre[i + 1] = bp2(pre[i], v2c[i], T, nT, qmax);
        int j = deg - 1 - i;
        suf[j] = bp2(v2c[j], suf[j + 1], T, nT, qmax);
    }
    for (int i = 0; i < deg; i++)
        out[i] = bp2(pre[i], suf[i + 1], T, nT, qmax);
}

/* One codeword, flooding schedule. Workspaces are caller-provided. */
static void decode_one_flooding(
    const int8_t *chan, int n, int m, int E,
    const int32_t *cn_ptr, const int32_t *cn_vars,
    int max_iter, int beta, int qmax, int anum, int ashift, int early_term,
    const int32_t *msT, int n_ms,
    uint8_t *hard, int32_t *iters_out, uint8_t *conv_out,
    int32_t *c2v, int32_t *total, int32_t *v2c_buf, int32_t *out_buf) {
    memset(c2v, 0, (size_t)E * sizeof(int32_t));
    for (int v = 0; v < n; v++) {
        total[v] = chan[v];
        hard[v] = chan[v] < 0;
    }
    int it_done = 0, converged = 0;
    if (early_term) {
        converged = 1;
        for (int c = 0; c < m && converged; c++) {
            int s = 0;
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                s ^= hard[cn_vars[e]];
            if (s) converged = 0;
        }
    }
    for (int it = 0; it < max_iter && !converged; it++) {
        /* CN pass reading iteration-start totals. */
        for (int c = 0; c < m; c++) {
            int deg = cn_ptr[c + 1] - cn_ptr[c];
            const int32_t *vs = cn_vars + cn_ptr[c];
            int32_t *cv = c2v + cn_ptr[c];
            for (int t = 0; t < deg; t++)
                v2c_buf[t] = CLIP(total[vs[t]] - cv[t], -qmax, qmax);
            if (n_ms > 0)
                cn_update_minstar(v2c_buf, deg, qmax, msT, n_ms, out_buf);
            else
                cn_update(v2c_buf, deg, beta, qmax, anum, ashift, out_buf);
            memcpy(cv, out_buf, (size_t)deg * sizeof(int32_t));
        }
        /* New totals + hard decision + syndrome. */
        for (int v = 0; v < n; v++) total[v] = chan[v];
        for (int c = 0; c < m; c++)
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                total[cn_vars[e]] += c2v[e];
        for (int v = 0; v < n; v++) hard[v] = total[v] < 0;
        it_done = it + 1;
        if (early_term) {
            converged = 1;
            for (int c = 0; c < m && converged; c++) {
                int s = 0;
                for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                    s ^= hard[cn_vars[e]];
                if (s) converged = 0;
            }
        }
    }
    if (!early_term) {
        converged = 1;
        for (int c = 0; c < m && converged; c++) {
            int s = 0;
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                s ^= hard[cn_vars[e]];
            if (s) converged = 0;
        }
    }
    *iters_out = it_done;
    *conv_out = (uint8_t)converged;
}

/* One codeword, layered schedule. layer_ptr/layer_checks give the layer
 * partition (checks listed layer-major). Within a layer all checks read the
 * pre-layer posterior (pre[] snapshot of the layer's touched variables —
 * cheap because layers touch each variable at most once, so reading the
 * live posterior before writing is equivalent; we exploit that directly). */
static void decode_one_layered(
    const int8_t *chan, int n, int m, int E,
    const int32_t *cn_ptr, const int32_t *cn_vars,
    int n_layers, const int32_t *layer_ptr, const int32_t *layer_checks,
    int max_iter, int beta, int qmax, int anum, int ashift, int early_term,
    const int32_t *msT, int n_ms,
    uint8_t *hard, int32_t *iters_out, uint8_t *conv_out,
    int32_t *c2v, int32_t *post, int32_t *v2c_buf, int32_t *out_buf) {
    memset(c2v, 0, (size_t)E * sizeof(int32_t));
    for (int v = 0; v < n; v++) {
        post[v] = chan[v];
        hard[v] = chan[v] < 0;
    }
    int it_done = 0, converged = 0;
    if (early_term) {
        converged = 1;
        for (int c = 0; c < m && converged; c++) {
            int s = 0;
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                s ^= hard[cn_vars[e]];
            if (s) converged = 0;
        }
    }
    for (int it = 0; it < max_iter && !converged; it++) {
        for (int l = 0; l < n_layers; l++) {
            for (int ci = layer_ptr[l]; ci < layer_ptr[l + 1]; ci++) {
                int c = layer_checks[ci];
                int deg = cn_ptr[c + 1] - cn_ptr[c];
                const int32_t *vs = cn_vars + cn_ptr[c];
                int32_t *cv = c2v + cn_ptr[c];
                for (int t = 0; t < deg; t++)
                    v2c_buf[t] = CLIP(post[vs[t]] - cv[t], -qmax, qmax);
                if (n_ms > 0)
                    cn_update_minstar(v2c_buf, deg, qmax, msT, n_ms,
                                      out_buf);
                else
                    cn_update(v2c_buf, deg, beta, qmax, anum, ashift,
                              out_buf);
                for (int t = 0; t < deg; t++) {
                    post[vs[t]] += out_buf[t] - cv[t];
                    cv[t] = out_buf[t];
                }
            }
        }
        for (int v = 0; v < n; v++) hard[v] = post[v] < 0;
        it_done = it + 1;
        if (early_term) {
            converged = 1;
            for (int c = 0; c < m && converged; c++) {
                int s = 0;
                for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                    s ^= hard[cn_vars[e]];
                if (s) converged = 0;
            }
        }
    }
    if (!early_term) {
        converged = 1;
        for (int c = 0; c < m && converged; c++) {
            int s = 0;
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                s ^= hard[cn_vars[e]];
            if (s) converged = 0;
        }
    }
    *iters_out = it_done;
    *conv_out = (uint8_t)converged;
}

/* Batched entry point. schedule: 0 = flooding, 1 = layered. Returns
 * ORACLE_OK, or an error code with the outputs undefined. */
int ldpc_decode_batch(
    const int8_t *chan, int B, int n, int m, int E,
    const int32_t *cn_ptr, const int32_t *cn_vars,
    int n_layers, const int32_t *layer_ptr, const int32_t *layer_checks,
    int schedule, int max_iter, int beta, int qmax, int anum,
    int ashift, int early_term,
    const int32_t *ms_thresh, int n_ms,
    uint8_t *hard, int32_t *iters, uint8_t *conv) {
    int max_deg = 0;
    for (int c = 0; c < m; c++) {
        int d = cn_ptr[c + 1] - cn_ptr[c];
        if (d > max_deg) max_deg = d;
    }
    /* cn_update_minstar's prefix/suffix chains live on fixed stack buffers
     * (pre[65]/suf[65]): refuse an out-of-family graph. */
    if (n_ms > 0 && max_deg > 64) return ORACLE_ERR_DEGREE;
    int status = ORACLE_OK;
#pragma omp parallel
    {
        int32_t *c2v = malloc((size_t)E * sizeof(int32_t));
        int32_t *work = malloc((size_t)n * sizeof(int32_t));
        int32_t *v2c_buf = malloc((size_t)(max_deg + 1) * sizeof(int32_t));
        int32_t *out_buf = malloc((size_t)(max_deg + 1) * sizeof(int32_t));
        const int ok = c2v && work && v2c_buf && out_buf;
        if (!ok) {
#pragma omp atomic write
            status = ORACLE_ERR_NOMEM;
        }
#pragma omp for schedule(dynamic, 1)
        for (int b = 0; b < B; b++) {
            if (!ok) continue;   /* the call fails; its outputs are not read */
            if (schedule == 0)
                decode_one_flooding(chan + (size_t)b * n, n, m, E, cn_ptr,
                                    cn_vars, max_iter, beta, qmax, anum, ashift, early_term,
                                    ms_thresh, n_ms,
                                    hard + (size_t)b * n, iters + b, conv + b,
                                    c2v, work, v2c_buf, out_buf);
            else
                decode_one_layered(chan + (size_t)b * n, n, m, E, cn_ptr,
                                   cn_vars, n_layers, layer_ptr, layer_checks,
                                   max_iter, beta, qmax, anum, ashift, early_term,
                                   ms_thresh, n_ms,
                                   hard + (size_t)b * n, iters + b, conv + b,
                                   c2v, work, v2c_buf, out_buf);
        }
        free(c2v);
        free(work);
        free(v2c_buf);
        free(out_buf);
    }
    return status;
}

/* ------------------------------------------------------------------------
 * Hard-decision decoder family (Gallager-A/B message passing, parallel
 * bit-flipping) — the BSC stress/study companions. Semantics pinned by
 * ldpc_tpu_torch/golden/decoder.py decode_hard/_decode_bitflip (see the
 * "Pinned semantics" block there); tests assert EXACT equality of hard
 * bits, per-codeword iteration counts, and convergence flags.
 * algorithm: 0 = gallager-b, 1 = gallager-a, 2 = bit-flip.
 * threshold < 0 selects the per-variable defaults (B: strict majority of
 * the other checks; A: all other checks; bit-flip: strict majority of a
 * variable's checks unsatisfied).
 * ---------------------------------------------------------------------- */

static int synd_ok_bits(const uint8_t *hard, int m, const int32_t *cn_ptr,
                        const int32_t *cn_vars) {
    for (int c = 0; c < m; c++) {
        int s = 0;
        for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
            s ^= hard[cn_vars[e]];
        if (s) return 0;
    }
    return 1;
}

static void decode_one_gallager(
    const uint8_t *y, int n, int m, int E,
    const int32_t *cn_ptr, const int32_t *cn_vars,
    const int32_t *thr, const int32_t *dv,
    int max_iter, int early_term,
    uint8_t *hard, int32_t *iters_out, uint8_t *conv_out,
    uint8_t *v2c, uint8_t *c2v, int32_t *dis) {
    for (int e = 0; e < E; e++) v2c[e] = 0;
    for (int c = 0; c < m; c++)
        for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
            v2c[e] = y[cn_vars[e]];
    memcpy(hard, y, (size_t)n);
    int it_done = 0;
    int converged = early_term ? synd_ok_bits(hard, m, cn_ptr, cn_vars) : 0;
    for (int it = 0; it < max_iter && !converged; it++) {
        /* CN pass: exclude-self XOR */
        for (int c = 0; c < m; c++) {
            int par = 0;
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++) par ^= v2c[e];
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                c2v[e] = (uint8_t)(par ^ v2c[e]);
        }
        /* decision: majority of incoming disagreements vs channel bit */
        memset(dis, 0, (size_t)n * sizeof(int32_t));
        for (int c = 0; c < m; c++)
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                dis[cn_vars[e]] += (c2v[e] != y[cn_vars[e]]);
        for (int v = 0; v < n; v++)
            hard[v] = (2 * dis[v] > dv[v]) ? (uint8_t)(1 - y[v]) : y[v];
        it_done = it + 1;
        if (early_term && synd_ok_bits(hard, m, cn_ptr, cn_vars)) {
            converged = 1;
            break;
        }
        /* VN pass: exclude-self disagreement count vs threshold */
        for (int c = 0; c < m; c++)
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++) {
                int v = cn_vars[e];
                int d_e = dis[v] - (c2v[e] != y[v]);
                v2c[e] = (d_e >= thr[v]) ? (uint8_t)(1 - y[v]) : y[v];
            }
    }
    if (!early_term)
        converged = synd_ok_bits(hard, m, cn_ptr, cn_vars);
    *iters_out = it_done;
    *conv_out = (uint8_t)converged;
}

static void decode_one_bitflip(
    const uint8_t *y, int n, int m,
    const int32_t *cn_ptr, const int32_t *cn_vars,
    int threshold, const int32_t *dv,
    int max_iter, int early_term,
    uint8_t *hard, int32_t *iters_out, uint8_t *conv_out,
    uint8_t *x, int32_t *unsat) {
    memcpy(x, y, (size_t)n);
    memcpy(hard, y, (size_t)n);
    int it_done = 0;
    int converged = early_term ? synd_ok_bits(hard, m, cn_ptr, cn_vars) : 0;
    for (int it = 0; it < max_iter && !converged; it++) {
        memset(unsat, 0, (size_t)n * sizeof(int32_t));
        for (int c = 0; c < m; c++) {
            int s = 0;
            for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                s ^= x[cn_vars[e]];
            if (s)
                for (int e = cn_ptr[c]; e < cn_ptr[c + 1]; e++)
                    unsat[cn_vars[e]]++;
        }
        for (int v = 0; v < n; v++) {
            int flip = (threshold >= 0) ? (unsat[v] >= threshold)
                                        : (2 * unsat[v] > dv[v]);
            if (flip) x[v] = (uint8_t)(1 - x[v]);
        }
        memcpy(hard, x, (size_t)n);
        it_done = it + 1;
        if (early_term && synd_ok_bits(hard, m, cn_ptr, cn_vars))
            converged = 1;
    }
    if (!early_term)
        converged = synd_ok_bits(hard, m, cn_ptr, cn_vars);
    *iters_out = it_done;
    *conv_out = (uint8_t)converged;
}

int ldpc_decode_hard_batch(
    const uint8_t *bits, int B, int n, int m, int E,
    const int32_t *cn_ptr, const int32_t *cn_vars,
    int algorithm, int max_iter, int threshold, int early_term,
    uint8_t *hard, int32_t *iters, uint8_t *conv) {
    /* per-variable degrees + default thresholds (golden
     * _default_thresholds: B = (dv-1)/2 + 1, A = max(dv-1, 1)) */
    int32_t *dv = malloc((size_t)n * sizeof(int32_t));
    int32_t *thr = malloc((size_t)n * sizeof(int32_t));
    if (!dv || !thr) {
        free(dv);
        free(thr);
        return ORACLE_ERR_NOMEM;
    }
    int status = ORACLE_OK;
    memset(dv, 0, (size_t)n * sizeof(int32_t));
    for (int e = 0; e < E; e++) dv[cn_vars[e]]++;
    for (int v = 0; v < n; v++) {
        if (threshold >= 0) thr[v] = threshold;
        else if (algorithm == 1) thr[v] = dv[v] - 1 > 1 ? dv[v] - 1 : 1;
        else thr[v] = (dv[v] - 1) / 2 + 1;
    }
#pragma omp parallel
    {
        /* v2c doubles as decode_one_bitflip's n-byte bit state, so the
         * shared scratch must cover max(E, n): a code with E < n would
         * otherwise overflow it. */
        size_t scr = (size_t)E > (size_t)n ? (size_t)E : (size_t)n;
        uint8_t *v2c = malloc(scr);
        uint8_t *c2v = malloc(scr);
        int32_t *work = malloc((size_t)n * sizeof(int32_t));
        const int ok = v2c && c2v && work;
        if (!ok) {
#pragma omp atomic write
            status = ORACLE_ERR_NOMEM;
        }
#pragma omp for schedule(dynamic, 1)
        for (int b = 0; b < B; b++) {
            if (!ok) continue;   /* the call fails; its outputs are not read */
            if (algorithm == 2)
                decode_one_bitflip(bits + (size_t)b * n, n, m, cn_ptr,
                                   cn_vars, threshold, dv, max_iter,
                                   early_term, hard + (size_t)b * n,
                                   iters + b, conv + b, v2c, work);
            else
                decode_one_gallager(bits + (size_t)b * n, n, m, E, cn_ptr,
                                    cn_vars, thr, dv, max_iter, early_term,
                                    hard + (size_t)b * n, iters + b,
                                    conv + b, v2c, c2v, work);
        }
        free(v2c);
        free(c2v);
        free(work);
    }
    free(dv);
    free(thr);
    return status;
}
