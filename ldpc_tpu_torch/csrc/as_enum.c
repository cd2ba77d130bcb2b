/* Exact enumeration of small connected trapping / absorbing sets.
 *
 * Role: closes the instrument gap the greedy census (analysis/trapping.py)
 * left open — greedy search rank-orders codes but cannot PROVE absence of
 * small sets. This module enumerates EVERY connected VN subset S with
 * |S| <= a_max (restricted to VNs the caller allows, typically low degree)
 * exactly once via the ESU algorithm (Wernicke 2006), maintains the
 * induced check parity incrementally, and tallies the (a, b) class of
 * each set with b <= b_max, flagging absorbing sets (every VN in S with
 * strictly more even- than odd-degree neighboring checks — Dolecek et
 * al.'s stability condition for min-sum/bit-flipping attractors).
 *
 * The reference codebase (a sequential C/MATLAB fixed-point LDPC
 * simulator, BASELINE.json:5) has no structural-analysis layer; this is
 * the framework's native-C analysis component, in the same role as
 * csrc/ldpc_oracle.c for decoding (SURVEY.md section 2.2: native
 * components get native equivalents).
 *
 * Exactness contract and its two scoping knobs (both reported honestly by
 * the Python wrapper, analysis/asenum.py):
 *   - connectivity: only CONNECTED sets are enumerated. A disconnected
 *     (a, b) set is a union of connected (a_i, b_i) sets with
 *     a = sum a_i, b = sum b_i, so its components are found separately.
 *   - allowed VNs: enumeration is restricted to VNs with allowed[v] != 0
 *     (the wrapper's dv_cap). High-degree hub columns explode the search
 *     space while being provably unable to sit in small low-b sets (a
 *     degree-d VN contributes d check-slots; inside a set of size a it
 *     can pair at most a-1 of them, so it alone forces
 *     b >= d - 2*(a-1) when its set-mates each share one check).
 *
 * Soundness of the branch-and-bound prune: adding one VN of degree at
 * most dv_eff toggles at most dv_eff check parities, so b can drop by at
 * most dv_eff per added VN. If b_cur > b_max + dv_eff*(a_max - |S|), no
 * completion within the size budget can reach b <= b_max, and the whole
 * ESU subtree (supersets of S along this path) is safely skipped.
 *
 * ESU uniqueness: each connected subset is generated exactly once, from
 * its minimum vertex as root, by only extending with exclusive neighbors
 * (> root, not adjacent to the current S). No deduplication needed.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#ifdef _OPENMP
#include <omp.h>
#endif

typedef int32_t i32;
typedef long long i64;

#define MAX_A 24

typedef struct {
    int n, m, a_max, b_max, dv_eff, emit_min_a;
    const i32 *vn_indptr, *vn_checks;   /* VN -> checks CSR (full graph)  */
    const i32 *adj_indptr, *adj;        /* VN -> VN adjacency CSR         */
    uint8_t *in_S;                      /* [n]                            */
    uint8_t *parity;                    /* [m] induced check parity       */
    i32 *nbr_cnt;                       /* [n] adjacent S-members         */
    i32 S[MAX_A];
    int s_len, b, root;
    i32 *ext_buf;                       /* a_max levels x n               */
    i64 *cls, *acls;                    /* (a_max+1)*(b_max+1)            */
    i64 nodes;
    /* shared emission (critical section) */
    i32 *out_sets, *out_ab;
    i32 emit_cap;
    i32 *n_emit;
} ctx_t;

static void toggle_vn(ctx_t *c, i32 w) {
    for (i32 k = c->vn_indptr[w]; k < c->vn_indptr[w + 1]; k++) {
        i32 ch = c->vn_checks[k];
        if (c->parity[ch]) { c->parity[ch] = 0; c->b--; }
        else               { c->parity[ch] = 1; c->b++; }
    }
}

static int set_is_absorbing(ctx_t *c) {
    for (int i = 0; i < c->s_len; i++) {
        i32 v = c->S[i];
        int dv = c->vn_indptr[v + 1] - c->vn_indptr[v], odd = 0;
        for (i32 k = c->vn_indptr[v]; k < c->vn_indptr[v + 1]; k++)
            odd += c->parity[c->vn_checks[k]];
        if (2 * odd >= dv) return 0;
    }
    return 1;
}

static void record(ctx_t *c) {
    if (c->b > c->b_max) return;
    int absb = set_is_absorbing(c);
    i64 idx = (i64)c->s_len * (c->b_max + 1) + c->b;
    c->cls[idx]++;
    if (absb) c->acls[idx]++;
    if (c->out_sets && c->s_len >= c->emit_min_a) {
#ifdef _OPENMP
#pragma omp critical(asenum_emit)
#endif
        {
            i32 r = *c->n_emit;
            if (r < c->emit_cap) {
                for (int i = 0; i < c->a_max; i++)
                    c->out_sets[(i64)r * c->a_max + i] =
                        i < c->s_len ? c->S[i] : -1;
                c->out_ab[(i64)r * 3 + 0] = c->s_len;
                c->out_ab[(i64)r * 3 + 1] = c->b;
                c->out_ab[(i64)r * 3 + 2] = absb;
                *c->n_emit = r + 1;
            }
        }
    }
}

static void extend(ctx_t *c, const i32 *ext, int ext_len) {
    i32 *child = c->ext_buf + (i64)(c->s_len - 1) * c->n;
    for (int i = 0; i < ext_len; i++) {
        i32 w = ext[i];
        c->nodes++;
        /* add w */
        c->S[c->s_len++] = w;
        c->in_S[w] = 1;
        toggle_vn(c, w);
        for (i32 k = c->adj_indptr[w]; k < c->adj_indptr[w + 1]; k++)
            c->nbr_cnt[c->adj[k]]++;
        record(c);
        if (c->s_len < c->a_max
            && c->b <= c->b_max + c->dv_eff * (c->a_max - c->s_len)) {
            /* child extension: the untried part of ext, plus w's
             * exclusive neighbors (> root, not in S, first touched by w:
             * their nbr_cnt is exactly the 1 we just added) */
            int cl = 0;
            for (int j = i + 1; j < ext_len; j++) child[cl++] = ext[j];
            for (i32 k = c->adj_indptr[w]; k < c->adj_indptr[w + 1]; k++) {
                i32 u = c->adj[k];
                if (u > c->root && !c->in_S[u] && c->nbr_cnt[u] == 1)
                    child[cl++] = u;
            }
            extend(c, child, cl);
        }
        /* remove w */
        for (i32 k = c->adj_indptr[w]; k < c->adj_indptr[w + 1]; k++)
            c->nbr_cnt[c->adj[k]]--;
        toggle_vn(c, w);
        c->in_S[w] = 0;
        c->s_len--;
    }
}

void ldpc_enum_connected(
    int n, int m,
    const i32 *vn_indptr, const i32 *vn_checks,
    const i32 *adj_indptr, const i32 *adj,
    const uint8_t *allowed, int dv_eff,
    int a_max, int b_max, int emit_min_a, int emit_cap,
    i32 *out_sets, i32 *out_ab, i32 *n_emitted,
    i64 *class_counts, i64 *absorb_counts, i64 *nodes_visited)
{
    i64 ncls = (i64)(a_max + 1) * (b_max + 1);
    memset(class_counts, 0, ncls * sizeof(i64));
    memset(absorb_counts, 0, ncls * sizeof(i64));
    *n_emitted = 0;
    i64 total_nodes = 0;
    if (a_max > MAX_A) a_max = MAX_A;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : total_nodes)
#endif
    {
        ctx_t c;
        memset(&c, 0, sizeof(c));
        c.n = n; c.m = m; c.a_max = a_max; c.b_max = b_max;
        c.dv_eff = dv_eff; c.emit_min_a = emit_min_a;
        c.vn_indptr = vn_indptr; c.vn_checks = vn_checks;
        c.adj_indptr = adj_indptr; c.adj = adj;
        c.in_S = calloc(n, 1);
        c.parity = calloc(m, 1);
        c.nbr_cnt = calloc(n, sizeof(i32));
        c.ext_buf = malloc((i64)a_max * n * sizeof(i32));
        c.cls = calloc(ncls, sizeof(i64));
        c.acls = calloc(ncls, sizeof(i64));
        c.out_sets = out_sets; c.out_ab = out_ab;
        c.emit_cap = emit_cap; c.n_emit = n_emitted;
        i32 *root_ext = malloc((i64)n * sizeof(i32));
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
        for (int v = 0; v < n; v++) {
            if (!allowed[v]) continue;
            c.root = v;
            c.S[0] = v; c.s_len = 1; c.in_S[v] = 1;
            c.b = 0;
            toggle_vn(&c, v);
            for (i32 k = adj_indptr[v]; k < adj_indptr[v + 1]; k++)
                c.nbr_cnt[adj[k]]++;
            c.nodes++;
            record(&c);
            if (a_max > 1
                && c.b <= b_max + dv_eff * (a_max - 1)) {
                int el = 0;
                for (i32 k = adj_indptr[v]; k < adj_indptr[v + 1]; k++)
                    if (adj[k] > v) root_ext[el++] = adj[k];
                extend(&c, root_ext, el);
            }
            for (i32 k = adj_indptr[v]; k < adj_indptr[v + 1]; k++)
                c.nbr_cnt[adj[k]]--;
            toggle_vn(&c, v);
            c.in_S[v] = 0; c.s_len = 0;
        }
#ifdef _OPENMP
#pragma omp critical(asenum_merge)
#endif
        {
            for (i64 i = 0; i < ncls; i++) {
                class_counts[i] += c.cls[i];
                absorb_counts[i] += c.acls[i];
            }
        }
        total_nodes += c.nodes;
        free(c.in_S); free(c.parity); free(c.nbr_cnt);
        free(c.ext_buf); free(c.cls); free(c.acls); free(root_ext);
    }
    *nodes_visited = total_nodes;
}
