// Barnes-Hut t-SNE gradient kernel: SpTree build + edge/non-edge forces.
//
// Role parity: reference clustering/sptree/SpTree.java (computeNonEdgeForces
// :computeEdgeForces) + plot/BarnesHutTsne.java's gradient — the reference
// runs these in Java (JIT-compiled); Python tree walks are ~100x too slow at
// real scale, so this framework puts the walk in C++ behind ctypes
// (clustering/native.py), with clustering/sptree.py as the pure-Python
// correctness oracle.
//
// Build: g++ -O3 -march=native -shared -fPIC -o _sptree.so _sptree.cpp

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct SPTree {
    int d;
    int n_children;
    std::vector<double> center;    // [nodes, d] cell centers
    std::vector<double> width;     // [nodes, d] half-widths
    std::vector<double> com;       // [nodes, d] centers of mass
    std::vector<long> count;       // [nodes]
    std::vector<long> point;       // [nodes] leaf payload or -1
    std::vector<long> children;    // [nodes, n_children]
    std::vector<double> maxw;      // [nodes] max half-width (theta test)
    const double* pts;
    long n_nodes = 0;

    SPTree(const double* Y, long n, int dim) : d(dim), pts(Y) {
        n_children = 1 << d;
        long cap = 4 * n + 64;
        center.resize((size_t)cap * d);
        width.resize((size_t)cap * d);
        com.assign((size_t)cap * d, 0.0);
        count.assign(cap, 0);
        point.assign(cap, -1);
        children.assign((size_t)cap * n_children, -1);
        maxw.assign(cap, 0.0);

        std::vector<double> lo(d, 1e300), hi(d, -1e300);
        for (long i = 0; i < n; i++)
            for (int a = 0; a < d; a++) {
                double v = Y[i * d + a];
                if (v < lo[a]) lo[a] = v;
                if (v > hi[a]) hi[a] = v;
            }
        n_nodes = 1;
        double mw = 0.0;
        for (int a = 0; a < d; a++) {
            center[a] = (lo[a] + hi[a]) / 2.0;
            double h = (hi[a] - lo[a]) / 2.0;
            if (h < 1e-10) h = 1e-10;
            width[a] = h * 1.0000001;
            if (width[a] > mw) mw = width[a];
        }
        maxw[0] = mw;
        for (long i = 0; i < n; i++) insert(0, i);
    }

    void grow() {
        size_t cap = count.size(), ncap = cap * 2;
        center.resize(ncap * d);
        width.resize(ncap * d);
        com.resize(ncap * d, 0.0);
        count.resize(ncap, 0);
        point.resize(ncap, -1);
        children.resize(ncap * n_children, -1);
        maxw.resize(ncap, 0.0);
    }

    int child_index(long node, const double* p) const {
        int idx = 0;
        for (int a = 0; a < d; a++)
            if (p[a] > center[node * d + a]) idx |= (1 << a);
        return idx;
    }

    long alloc_child(long node, int ci) {
        if ((size_t)n_nodes >= count.size()) grow();
        long nn = n_nodes++;
        double mw = 0.0;
        for (int a = 0; a < d; a++) {
            double h = width[node * d + a] / 2.0;
            width[nn * d + a] = h;
            center[nn * d + a] = center[node * d + a]
                + (((ci >> a) & 1) ? h : -h);
            if (h > mw) mw = h;
        }
        maxw[nn] = mw;
        children[node * n_children + ci] = nn;
        return nn;
    }

    bool same_point(long i, long j) const {
        for (int a = 0; a < d; a++)
            if (std::fabs(pts[i * d + a] - pts[j * d + a]) > 1e-12)
                return false;
        return true;
    }

    void insert(long node, long i) {
        const double* p = pts + i * d;
        while (true) {
            long c = count[node];
            for (int a = 0; a < d; a++)
                com[node * d + a] =
                    (com[node * d + a] * c + p[a]) / (c + 1);
            count[node] = c + 1;
            if (c == 0) { point[node] = i; return; }
            if (point[node] >= 0) {
                long j = point[node];
                if (same_point(i, j)) return;  // duplicate: mass only
                point[node] = -1;
                int cj = child_index(node, pts + j * d);
                long ch = children[node * n_children + cj];
                if (ch < 0) ch = alloc_child(node, cj);
                insert(ch, j);
            }
            int ci = child_index(node, p);
            long ch = children[node * n_children + ci];
            if (ch < 0) ch = alloc_child(node, ci);
            node = ch;
        }
    }

    // repulsive force on point i; adds into neg[d], returns sum_Q part
    double non_edge_forces(long i, double theta2, double* neg,
                           std::vector<long>& stack) const {
        const double* p = pts + i * d;
        double sum_q = 0.0;
        stack.clear();
        stack.push_back(0);
        while (!stack.empty()) {
            long node = stack.back();
            stack.pop_back();
            long cnt = count[node];
            if (cnt == 0) continue;
            if (point[node] == i && cnt == 1) continue;
            double d2 = 0.0;
            for (int a = 0; a < d; a++) {
                double diff = p[a] - com[node * d + a];
                d2 += diff * diff;
            }
            bool leaf = point[node] >= 0;
            if (leaf || maxw[node] * maxw[node] < theta2 * d2) {
                long eff = cnt - (point[node] == i ? 1 : 0);
                if (eff <= 0) continue;
                double q = 1.0 / (1.0 + d2);
                sum_q += eff * q;
                double qq = eff * q * q;
                for (int a = 0; a < d; a++)
                    neg[a] += qq * (p[a] - com[node * d + a]);
            } else {
                const long* ch = &children[node * n_children];
                for (int k = 0; k < n_children; k++)
                    if (ch[k] >= 0) stack.push_back(ch[k]);
            }
        }
        return sum_q;
    }
};

}  // namespace

extern "C" {

// Full BH t-SNE gradient. Y [n,d] row-major, P in CSR (row_ptr [n+1],
// cols/vals [nnz]). Writes dC [n,d] and *kl (exact KL given the BH sum_Q
// approximation). Returns 0 on success.
int bh_tsne_gradient(const double* Y, long n, int d,
                     const long* row_ptr, const long* cols,
                     const double* vals, double theta,
                     double* dC, double* kl) {
    SPTree tree(Y, n, d);
    std::vector<double> neg((size_t)n * d, 0.0);
    std::vector<double> pos((size_t)n * d, 0.0);
    double sum_q = 0.0;
    std::vector<long> stack;
    stack.reserve(256);
    double theta2 = theta * theta;
    for (long i = 0; i < n; i++)
        sum_q += tree.non_edge_forces(i, theta2, &neg[i * d], stack);
    if (sum_q <= 0.0) sum_q = 1e-12;

    double kl_acc = 0.0;
    for (long i = 0; i < n; i++) {
        const double* pi = Y + i * d;
        for (long e = row_ptr[i]; e < row_ptr[i + 1]; e++) {
            long j = cols[e];
            double d2 = 0.0;
            for (int a = 0; a < d; a++) {
                double diff = pi[a] - Y[j * d + a];
                d2 += diff * diff;
            }
            double q = 1.0 / (1.0 + d2);
            double pq = vals[e] * q;
            for (int a = 0; a < d; a++)
                pos[i * d + a] += pq * (pi[a] - Y[j * d + a]);
            double qn = q / sum_q;
            if (vals[e] > 1e-12)
                kl_acc += vals[e] * std::log(vals[e] / (qn > 1e-12
                                                        ? qn : 1e-12));
        }
    }
    for (long i = 0; i < n; i++)
        for (int a = 0; a < d; a++)
            dC[i * d + a] = 4.0 * (pos[i * d + a]
                                   - neg[i * d + a] / sum_q);
    if (kl) *kl = kl_acc;
    return 0;
}

// Standalone non-edge forces for one point (test hook mirroring
// SpTree.computeNonEdgeForces).
double bh_non_edge_forces(const double* Y, long n, int d, long i,
                          double theta, double* neg) {
    SPTree tree(Y, n, d);
    std::vector<long> stack;
    for (int a = 0; a < d; a++) neg[a] = 0.0;
    return tree.non_edge_forces(i, theta * theta, neg, stack);
}

}  // extern "C"
