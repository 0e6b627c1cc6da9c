// Native CPU conflict set: the performance baseline the reference keeps in
// fdbserver/SkipList.cpp (ConflictBatch::detectConflicts, :909-956),
// reformulated over an ordered boundary map instead of a hand-built skip
// list: V(key) is piecewise-constant; a std::map<key, version> holds the
// segment boundaries (the skip list's nodes), queries take max over the
// intersecting segments, inserts erase interior boundaries and set the
// range to the new version (addConflictRanges :430-441), and removeBefore
// (:576) merges sub-floor segments.  Exposed as a C ABI for ctypes; batch
// payloads use the framework's little-endian length-prefixed wire format
// (core/wire.py).
//
// Batch request layout (all little-endian):
//   i64 now; i64 new_oldest; u32 n_txns;
//   per txn: i64 snapshot; u8 has_reads;
//            u32 n_reads;  per read:  u32 blen,b / u32 elen,e
//            u32 n_writes; per write: u32 blen,b / u32 elen,e
// Reply: one byte per txn (CommitResult: 0 conflict, 1 too-old, 2 committed).

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

using Key = std::string;

struct ConflictSet {
    // boundary -> version of segment [boundary, next boundary)
    std::map<Key, int64_t> segments;
    int64_t oldest = 0;
    ConflictSet(int64_t oldest_version) : oldest(oldest_version) {
        segments[Key()] = oldest_version;
    }

    int64_t range_max(const Key& b, const Key& e) const {
        auto it = segments.upper_bound(b);
        --it;  // segment containing b (map always has the "" boundary)
        int64_t m = it->second;
        for (++it; it != segments.end() && it->first < e; ++it)
            if (it->second > m) m = it->second;
        return m;
    }

    void insert_range(const Key& b, const Key& e, int64_t version) {
        // Version continuing after e = value of segment containing e.
        auto ite = segments.upper_bound(e);
        int64_t cont = std::prev(ite)->second;
        auto itb = segments.lower_bound(b);
        segments.erase(itb, ite);
        segments[b] = version;
        segments[e] = cont;
    }

    void remove_before(int64_t floor_version) {
        // Drop a boundary when it and its predecessor are both below the
        // floor (SkipList.cpp:576 wasAbove logic).
        if (floor_version <= oldest) return;
        oldest = floor_version;
        auto it = segments.begin();
        bool prev_above = true;  // first boundary always kept
        ++it;
        while (it != segments.end()) {
            bool above = it->second >= floor_version;
            if (!above && !prev_above)
                it = segments.erase(it);
            else
                ++it;
            prev_above = above;
        }
    }
};

inline uint32_t rd_u32(const uint8_t*& p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
}
inline int64_t rd_i64(const uint8_t*& p) {
    int64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
}
inline Key rd_key(const uint8_t*& p) {
    uint32_t n = rd_u32(p);
    Key k(reinterpret_cast<const char*>(p), n);
    p += n;
    return k;
}

}  // namespace

extern "C" {

void* cs_new(int64_t oldest_version) {
    return new ConflictSet(oldest_version);
}

void cs_free(void* h) { delete static_cast<ConflictSet*>(h); }

int64_t cs_segment_count(void* h) {
    return static_cast<int64_t>(
        static_cast<ConflictSet*>(h)->segments.size());
}

// Resolve one batch; writes n_txns verdict bytes into out.
// Returns 0 on success.
int cs_resolve(void* h, const uint8_t* req, int64_t req_len, uint8_t* out) {
    ConflictSet& cs = *static_cast<ConflictSet*>(h);
    const uint8_t* p = req;
    int64_t now = rd_i64(p);
    int64_t new_oldest = rd_i64(p);
    uint32_t n_txns = rd_u32(p);

    struct Range { Key b, e; };
    struct Txn {
        int64_t snapshot;
        bool has_reads;
        std::vector<Range> reads, writes;
    };
    std::vector<Txn> txns(n_txns);
    for (uint32_t t = 0; t < n_txns; t++) {
        txns[t].snapshot = rd_i64(p);
        txns[t].has_reads = *p++ != 0;
        uint32_t nr = rd_u32(p);
        txns[t].reads.resize(nr);
        for (uint32_t i = 0; i < nr; i++) {
            txns[t].reads[i].b = rd_key(p);
            txns[t].reads[i].e = rd_key(p);
        }
        uint32_t nw = rd_u32(p);
        txns[t].writes.resize(nw);
        for (uint32_t i = 0; i < nw; i++) {
            txns[t].writes[i].b = rd_key(p);
            txns[t].writes[i].e = rd_key(p);
        }
    }
    if (p != req + req_len) return 1;

    // Sequential semantics (checkIntraBatchConflicts :874): process txns
    // in order against history + an intra-batch overlay of SURVIVING
    // earlier writers.
    // boundary -> MINIMUM surviving writer txn idx covering the segment
    // (INT64_MAX = none).  Min matters: a later writer must not mask an
    // earlier one, or a mid-batch reader would miss its conflict.
    constexpr int64_t kNone = INT64_MAX;
    std::map<Key, int64_t> overlay;
    overlay[Key()] = kNone;
    auto overlay_hit = [&](const Key& b, const Key& e, int64_t me) {
        auto it = overlay.upper_bound(b);
        --it;
        if (it->second < me) return true;
        for (++it; it != overlay.end() && it->first < e; ++it)
            if (it->second < me) return true;
        return false;
    };
    auto ensure_boundary = [&](const Key& k) {
        auto it = overlay.upper_bound(k);
        --it;
        if (it->first != k) overlay[k] = it->second;
    };
    auto overlay_insert = [&](const Key& b, const Key& e, int64_t idx) {
        ensure_boundary(b);
        ensure_boundary(e);
        for (auto it = overlay.find(b); it != overlay.end() && it->first < e;
             ++it)
            if (idx < it->second) it->second = idx;
    };

    for (uint32_t t = 0; t < n_txns; t++) {
        const Txn& txn = txns[t];
        uint8_t verdict = 2;  // committed
        if (txn.has_reads && txn.snapshot < cs.oldest) {
            verdict = 1;  // too old (SkipList.cpp:826)
        } else {
            for (const Range& r : txn.reads) {
                if (cs.range_max(r.b, r.e) > txn.snapshot ||
                    overlay_hit(r.b, r.e, t)) {
                    verdict = 0;
                    break;
                }
            }
        }
        if (verdict == 2) {
            for (const Range& w : txn.writes)
                overlay_insert(w.b, w.e, t);
        }
        out[t] = verdict;
    }
    // Insert surviving writes at `now`, then GC (order matches the
    // reference: mergeWriteConflictRanges then removeBefore).
    for (uint32_t t = 0; t < n_txns; t++)
        if (out[t] == 2)
            for (const Range& w : txns[t].writes)
                cs.insert_range(w.b, w.e, now);
    if (new_oldest > cs.oldest) cs.remove_before(new_oldest);
    return 0;
}

}  // extern "C"
