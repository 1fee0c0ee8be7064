// HNSW graph index (C++ host runtime).
//
// Native replacement for the hnswlib dependency the reference declared but
// never wired up (reference pyproject.toml:50-52, src/index/ stub).  Graph
// construction and traversal are pointer-chasing workloads that belong on the
// host CPU; the TPU handles embedding generation and exact re-ranking
// (kobato_eyes_tpu/index/flat.py).  Exposed through a C ABI consumed via
// ctypes (kobato_eyes_tpu/index/hnsw.py).
//
// Algorithm: Malkov & Yashunin, "Efficient and robust approximate nearest
// neighbor search using Hierarchical Navigable Small World graphs" (2016).
// Similarity is inner product over caller-normalized vectors (cosine).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Candidate {
    float sim;
    int32_t node;
};
struct BySimAsc {  // min-heap on similarity (worst at top)
    bool operator()(const Candidate& a, const Candidate& b) const { return a.sim > b.sim; }
};
struct BySimDesc {  // max-heap on similarity (best at top)
    bool operator()(const Candidate& a, const Candidate& b) const { return a.sim < b.sim; }
};

class HnswIndex {
  public:
    HnswIndex(int dim, int M, int ef_construction, uint32_t seed)
        : dim_(dim),
          M_(M),
          max_m_(M),
          max_m0_(2 * M),
          ef_construction_(std::max(ef_construction, M)),
          level_mult_(1.0 / std::log(std::max(2, M))),
          rng_(seed) {}

    int64_t size() const { return static_cast<int64_t>(ids_.size()); }
    int dim() const { return dim_; }

    int32_t add(const float* vec, int64_t id) {
        const int32_t node = reserve_node(vec, id);
        link_node(node);
        return node;
    }

    void add_batch_parallel(const float* vecs, const int64_t* ids, int64_t n) {
        if (n <= 0) return;
        int64_t i0 = 0;
        if (ids_.empty()) {  // seed the graph sequentially
            add(vecs, ids[0]);
            i0 = 1;
        }
        const int64_t remaining = n - i0;
        if (remaining <= 0) return;
        std::vector<int32_t> nodes(remaining);
        for (int64_t i = 0; i < remaining; ++i)
            nodes[i] = reserve_node(vecs + (i0 + i) * dim_, ids[i0 + i]);
        unsigned hw = std::thread::hardware_concurrency();
        const int n_threads = std::max(1u, std::min(hw ? hw : 1u, 16u));
        if (n_threads == 1 || remaining < 64) {
            for (int32_t node : nodes) link_node(node);
            return;
        }
        std::atomic<int64_t> cursor{0};
        std::vector<std::thread> workers;
        workers.reserve(n_threads);
        for (int t = 0; t < n_threads; ++t) {
            workers.emplace_back([&] {
                while (true) {
                    const int64_t i = cursor.fetch_add(1);
                    if (i >= remaining) break;
                    link_node(nodes[i]);
                }
            });
        }
        for (auto& w : workers) w.join();
    }

    int search(const float* query, int k, int ef, int64_t* out_ids, float* out_scores) const {
        if (ids_.empty()) return 0;
        int32_t cur = entry_;
        for (int lc = max_level_; lc > 0; --lc) cur = greedy_closest(query, cur, lc);
        auto cands = search_layer(query, cur, std::max(ef, k), 0);
        std::sort(cands.begin(), cands.end(),
                  [](const Candidate& a, const Candidate& b) { return a.sim > b.sim; });
        const int n = std::min<int>(k, static_cast<int>(cands.size()));
        for (int i = 0; i < n; ++i) {
            out_ids[i] = ids_[cands[i].node];
            out_scores[i] = cands[i].sim;
        }
        return n;
    }

    bool save(const char* path) const {
        FILE* f = std::fopen(path, "wb");
        if (!f) return false;
        const uint32_t magic = 0x48534E57;  // "WNSH"
        const int64_t n = size();
        const int32_t entry_v = entry_.load();
        const int max_level_v = max_level_.load();
        std::fwrite(&magic, 4, 1, f);
        std::fwrite(&dim_, 4, 1, f);
        std::fwrite(&M_, 4, 1, f);
        std::fwrite(&ef_construction_, 4, 1, f);
        std::fwrite(&entry_v, 4, 1, f);
        std::fwrite(&max_level_v, 4, 1, f);
        std::fwrite(&n, 8, 1, f);
        std::fwrite(ids_.data(), 8, n, f);
        std::fwrite(levels_.data(), 4, n, f);
        std::fwrite(vectors_.data(), 4, n * dim_, f);
        for (int64_t i = 0; i < n; ++i) {
            const int32_t nl = static_cast<int32_t>(links_[i].size());
            std::fwrite(&nl, 4, 1, f);
            for (const auto& layer : links_[i]) {
                const int32_t sz = static_cast<int32_t>(layer.size());
                std::fwrite(&sz, 4, 1, f);
                std::fwrite(layer.data(), 4, sz, f);
            }
        }
        std::fclose(f);
        return true;
    }

    bool load(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (!f) return false;
        uint32_t magic = 0;
        int64_t n = 0;
        int32_t entry_v = -1;
        int max_level_v = -1;
        bool ok = std::fread(&magic, 4, 1, f) == 1 && magic == 0x48534E57 &&
                  std::fread(&dim_, 4, 1, f) == 1 && std::fread(&M_, 4, 1, f) == 1 &&
                  std::fread(&ef_construction_, 4, 1, f) == 1 &&
                  std::fread(&entry_v, 4, 1, f) == 1 && std::fread(&max_level_v, 4, 1, f) == 1 &&
                  std::fread(&n, 8, 1, f) == 1;
        if (ok) {
            entry_.store(entry_v);
            max_level_.store(max_level_v);
            max_m_ = M_;
            max_m0_ = 2 * M_;
            ids_.resize(n);
            levels_.resize(n);
            vectors_.resize(n * dim_);
            locks_.resize(n);
            ok = std::fread(ids_.data(), 8, n, f) == static_cast<size_t>(n) &&
                 std::fread(levels_.data(), 4, n, f) == static_cast<size_t>(n) &&
                 std::fread(vectors_.data(), 4, n * dim_, f) == static_cast<size_t>(n * dim_);
            links_.assign(n, {});
            for (int64_t i = 0; ok && i < n; ++i) {
                int32_t nl = 0;
                ok = std::fread(&nl, 4, 1, f) == 1;
                links_[i].resize(nl);
                for (int32_t l = 0; ok && l < nl; ++l) {
                    int32_t sz = 0;
                    ok = std::fread(&sz, 4, 1, f) == 1;
                    links_[i][l].resize(sz);
                    ok = ok && std::fread(links_[i][l].data(), 4, sz, f) == static_cast<size_t>(sz);
                }
            }
        }
        std::fclose(f);
        return ok;
    }

  private:
    float sim(const float* __restrict a, int32_t node) const {
        const float* __restrict b = vectors_.data() + static_cast<size_t>(node) * dim_;
        // four accumulators so the compiler vectorizes + pipelines the FMA
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
        int i = 0;
        const int limit = dim_ - (dim_ % 4);
        for (; i < limit; i += 4) {
            acc0 += a[i] * b[i];
            acc1 += a[i + 1] * b[i + 1];
            acc2 += a[i + 2] * b[i + 2];
            acc3 += a[i + 3] * b[i + 3];
        }
        for (; i < dim_; ++i) acc0 += a[i] * b[i];
        return (acc0 + acc1) + (acc2 + acc3);
    }

    int sample_level() {
        std::uniform_real_distribution<double> u(0.0, 1.0);
        double r = u(rng_);
        if (r <= 0.0) r = 1e-12;
        return static_cast<int>(-std::log(r) * level_mult_);
    }

    // allocate storage for a node (sequential; structure mutations only)
    int32_t reserve_node(const float* vec, int64_t id) {
        std::lock_guard<std::mutex> g(global_);
        const int32_t node = static_cast<int32_t>(ids_.size());
        const int level = sample_level();
        ids_.push_back(id);
        levels_.push_back(level);
        vectors_.insert(vectors_.end(), vec, vec + dim_);
        links_.emplace_back();
        links_.back().resize(level + 1);
        locks_.emplace_back();
        if (node == 0) {
            entry_ = 0;
            max_level_ = level;
        }
        return node;
    }

    // wire a reserved node into the graph (safe to run concurrently)
    void link_node(int32_t node) {
        if (node == 0) return;
        const float* vec = vectors_.data() + static_cast<size_t>(node) * dim_;
        const int level = levels_[node];

        std::unique_lock<std::mutex> promote;
        if (level > max_level_.load()) {
            // level promotions serialize the whole insert (rare; hnswlib does
            // the same) so entry_/max_level_ stay consistent
            promote = std::unique_lock<std::mutex>(promote_);
        }
        int32_t cur = entry_.load();
        const int top = max_level_.load();
        for (int lc = top; lc > level; --lc) cur = greedy_closest(vec, cur, lc);

        for (int lc = std::min(level, top); lc >= 0; --lc) {
            auto cands = search_layer(vec, cur, ef_construction_, lc);
            const int m = (lc == 0) ? max_m0_ : max_m_;
            auto selected = select_neighbors(cands, M_);
            {
                std::lock_guard<std::mutex> g(locks_[node]);
                auto& my_links = links_[node][lc];
                for (const auto& c : selected) my_links.push_back(c.node);
            }
            for (const auto& c : selected) {
                std::lock_guard<std::mutex> g(locks_[c.node]);
                if (lc >= static_cast<int>(links_[c.node].size())) continue;
                auto& their = links_[c.node][lc];
                their.push_back(node);
                if (static_cast<int>(their.size()) > m) shrink_locked(c.node, lc, m);
            }
            if (!selected.empty()) cur = selected.front().node;
        }
        if (level > max_level_.load()) {
            max_level_.store(level);
            entry_.store(node);
        }
    }

    std::vector<int32_t> neighbors(int32_t node, int level) const {
        std::lock_guard<std::mutex> g(locks_[node]);
        const auto& ls = links_[node];
        if (level >= static_cast<int>(ls.size())) return {};
        return ls[level];
    }

    int32_t greedy_closest(const float* q, int32_t start, int level) const {
        int32_t cur = start;
        float best = sim(q, cur);
        bool improved = true;
        while (improved) {
            improved = false;
            for (int32_t nb : neighbors(cur, level)) {
                const float s = sim(q, nb);
                if (s > best) {
                    best = s;
                    cur = nb;
                    improved = true;
                }
            }
        }
        return cur;
    }

    std::vector<Candidate> search_layer(const float* q, int32_t entry, int ef, int level) const {
        // per-thread visited marks (concurrent inserts/searches)
        thread_local std::vector<uint32_t> visited;
        thread_local uint32_t epoch = 0;
        const size_t n = ids_.size();
        if (visited.size() < n) visited.resize(n, 0);
        if (++epoch == 0) {  // wrapped: clear and restart
            std::fill(visited.begin(), visited.end(), 0);
            epoch = 1;
        }
        std::priority_queue<Candidate, std::vector<Candidate>, BySimDesc> frontier;
        std::priority_queue<Candidate, std::vector<Candidate>, BySimAsc> best;  // worst on top
        const float s0 = sim(q, entry);
        frontier.push({s0, entry});
        best.push({s0, entry});
        visited[entry] = epoch;
        while (!frontier.empty()) {
            Candidate c = frontier.top();
            frontier.pop();
            if (static_cast<int>(best.size()) >= ef && c.sim < best.top().sim) break;
            for (int32_t nb : neighbors(c.node, level)) {
                if (static_cast<size_t>(nb) >= visited.size() || visited[nb] == epoch) continue;
                visited[nb] = epoch;
                const float s = sim(q, nb);
                if (static_cast<int>(best.size()) < ef || s > best.top().sim) {
                    frontier.push({s, nb});
                    best.push({s, nb});
                    if (static_cast<int>(best.size()) > ef) best.pop();
                }
            }
        }
        std::vector<Candidate> out;
        out.reserve(best.size());
        while (!best.empty()) {
            out.push_back(best.top());
            best.pop();
        }
        return out;  // ascending by sim
    }

    // Heuristic neighbor selection (keeps diverse edges; Malkov alg. 4).
    std::vector<Candidate> select_neighbors(std::vector<Candidate> cands, int m) const {
        std::sort(cands.begin(), cands.end(),
                  [](const Candidate& a, const Candidate& b) { return a.sim > b.sim; });
        std::vector<Candidate> selected;
        for (const auto& c : cands) {
            if (static_cast<int>(selected.size()) >= m) break;
            const float* cv = vectors_.data() + static_cast<size_t>(c.node) * dim_;
            bool keep = true;
            for (const auto& s : selected) {
                if (sim(cv, s.node) > c.sim) {  // closer to a selected point than to q
                    keep = false;
                    break;
                }
            }
            if (keep) selected.push_back(c);
        }
        // backfill when the heuristic was too aggressive
        for (const auto& c : cands) {
            if (static_cast<int>(selected.size()) >= m) break;
            bool already = false;
            for (const auto& s : selected)
                if (s.node == c.node) { already = true; break; }
            if (!already) selected.push_back(c);
        }
        return selected;
    }

    // caller must hold locks_[node]
    void shrink_locked(int32_t node, int level, int m) {
        auto& layer = links_[node][level];
        const float* v = vectors_.data() + static_cast<size_t>(node) * dim_;
        std::vector<Candidate> cands;
        cands.reserve(layer.size());
        for (int32_t nb : layer) cands.push_back({sim(v, nb), nb});
        auto selected = select_neighbors(std::move(cands), m);
        layer.clear();
        for (const auto& s : selected) layer.push_back(s.node);
    }

    int dim_;
    int M_;
    int max_m_;
    int max_m0_;
    int ef_construction_;
    double level_mult_;
    std::mt19937 rng_;
    std::atomic<int32_t> entry_{-1};
    std::atomic<int> max_level_{-1};
    std::vector<int64_t> ids_;
    std::vector<int> levels_;
    std::vector<float> vectors_;
    std::vector<std::vector<std::vector<int32_t>>> links_;
    mutable std::deque<std::mutex> locks_;  // per-node; deque: grows w/o moving
    std::mutex global_;   // structure growth (reserve phase)
    std::mutex promote_;  // level-promotion serialization
};

}  // namespace

extern "C" {

void* hnsw_create(int dim, int M, int ef_construction, uint32_t seed) {
    return new HnswIndex(dim, M, ef_construction, seed);
}

void hnsw_free(void* h) { delete static_cast<HnswIndex*>(h); }

int64_t hnsw_size(void* h) { return static_cast<HnswIndex*>(h)->size(); }

int hnsw_dim(void* h) { return static_cast<HnswIndex*>(h)->dim(); }

void hnsw_add_batch(void* h, const float* vecs, const int64_t* ids, int64_t n) {
    auto* idx = static_cast<HnswIndex*>(h);
    idx->add_batch_parallel(vecs, ids, n);
}

void hnsw_search_batch(void* h, const float* queries, int64_t nq, int k, int ef,
                       int64_t* out_ids, float* out_scores, int32_t* out_counts) {
    auto* idx = static_cast<HnswIndex*>(h);
    const int d = idx->dim();
    for (int64_t i = 0; i < nq; ++i) {
        out_counts[i] = idx->search(queries + i * d, k, ef, out_ids + i * k, out_scores + i * k);
        for (int j = out_counts[i]; j < k; ++j) {
            out_ids[i * k + j] = -1;
            out_scores[i * k + j] = -1e30f;
        }
    }
}

int hnsw_save(void* h, const char* path) {
    return static_cast<HnswIndex*>(h)->save(path) ? 0 : -1;
}

int hnsw_load(void* h, const char* path) {
    return static_cast<HnswIndex*>(h)->load(path) ? 0 : -1;
}

}  // extern "C"
