// Native binary sum tree for prioritized experience replay.
//
// The reference keeps PER in a host-side python SumTree with O(log n)
// serial add/update/get_leaf walks (reference elasticnet/enet_sac.py:82-200).
// The TPU build's default PER lives in HBM as a vectorised prefix-sum
// search (smartcal_tpu/rl/replay.py); SURVEY.md §7 ("PER on TPU") calls for
// measuring BOTH designs — this file is the host-side tree, in C++ so the
// per-sample pointer chase costs nanoseconds instead of python-interpreter
// microseconds.  Bound via ctypes (no pybind11 in this image).
//
// Layout: classic implicit heap over a power-of-two leaf count `cap`:
// tree[1] is the root (total priority), leaves occupy tree[cap .. 2cap-1];
// leaf i of the ring buffer is tree[cap + i].

#include <cstdint>
#include <vector>

namespace {

struct SumTree {
  int64_t cap;                // leaves, power of two
  std::vector<double> tree;   // 2*cap entries, index 0 unused (sums)
  std::vector<double> maxt;   // max overlay, same layout — O(log n)
                              // max-priority queries for the PER
                              // max-priority store rule, which runs on
                              // EVERY default-priority store
  int64_t cursor;             // next leaf to write (ring)
  int64_t filled;             // number of leaves ever written (<= cap)
};

void propagate(SumTree* t, int64_t node) {
  for (node >>= 1; node >= 1; node >>= 1) {
    t->tree[node] = t->tree[2 * node] + t->tree[2 * node + 1];
    double l = t->maxt[2 * node], r = t->maxt[2 * node + 1];
    t->maxt[node] = l > r ? l : r;
  }
}

}  // namespace

extern "C" {

// capacity is rounded UP to the next power of two (the reference asserts
// power-of-two capacity instead, enet_sac.py:90-93).
void* st_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  int64_t cap = 1;
  while (cap < capacity) cap <<= 1;
  auto* t = new SumTree();
  t->cap = cap;
  t->tree.assign(2 * cap, 0.0);
  t->maxt.assign(2 * cap, 0.0);
  t->cursor = 0;
  t->filled = 0;
  return t;
}

void st_free(void* h) { delete static_cast<SumTree*>(h); }

int64_t st_capacity(void* h) { return static_cast<SumTree*>(h)->cap; }
int64_t st_filled(void* h) { return static_cast<SumTree*>(h)->filled; }
int64_t st_cursor(void* h) { return static_cast<SumTree*>(h)->cursor; }

double st_total(void* h) { return static_cast<SumTree*>(h)->tree[1]; }

// Max leaf priority (PER max-priority init, enet_sac.py:237-241); O(1)
// off the max overlay.  Unfilled leaves hold 0 and priorities are
// non-negative, so the overlay root IS the filled-prefix max; 0 when empty.
double st_max_priority(void* h) {
  return static_cast<SumTree*>(h)->maxt[1];
}

// Min non-zero leaf probability numerator (some PER variants need it for
// the max-IS-weight bound).  0 when empty.  O(n) linear scan — NOT on any
// per-store path (unused by NativePER; exposed for completeness).
double st_min_priority(void* h) {
  auto* t = static_cast<SumTree*>(h);
  double m = 0.0;
  bool any = false;
  for (int64_t i = 0; i < t->filled; ++i) {
    double v = t->tree[t->cap + i];
    if (v > 0.0 && (!any || v < m)) { m = v; any = true; }
  }
  return any ? m : 0.0;
}

// Append at the ring cursor (SumTree.add, enet_sac.py:120-131); returns the
// leaf index written.
int64_t st_add(void* h, double priority) {
  auto* t = static_cast<SumTree*>(h);
  int64_t leaf = t->cursor;
  t->tree[t->cap + leaf] = priority;
  t->maxt[t->cap + leaf] = priority;
  propagate(t, t->cap + leaf);
  t->cursor = (t->cursor + 1) % t->cap;
  if (t->filled < t->cap) ++t->filled;
  return leaf;
}

void st_update(void* h, int64_t leaf, double priority) {
  auto* t = static_cast<SumTree*>(h);
  if (leaf < 0 || leaf >= t->cap) return;
  t->tree[t->cap + leaf] = priority;
  t->maxt[t->cap + leaf] = priority;
  propagate(t, t->cap + leaf);
}

void st_update_batch(void* h, int64_t n, const int64_t* leaves,
                     const double* priorities) {
  for (int64_t i = 0; i < n; ++i) st_update(h, leaves[i], priorities[i]);
}

// Root-to-leaf walk for cumulative value v (SumTree.get_leaf,
// enet_sac.py:164-196).  Returns the leaf index; *priority_out gets its
// priority.
int64_t st_get_leaf(void* h, double v, double* priority_out) {
  auto* t = static_cast<SumTree*>(h);
  int64_t node = 1;
  while (node < t->cap) {
    int64_t left = 2 * node;
    if (v <= t->tree[left]) {
      node = left;
    } else {
      v -= t->tree[left];
      node = left + 1;
    }
  }
  if (priority_out) *priority_out = t->tree[node];
  return node - t->cap;
}

// Stratified sampling (PER.sample_buffer, enet_sac.py:270-312): segment i
// draws v = (i + uniforms[i]) * total / batch and walks the tree.  The
// caller supplies the uniforms so the python side keeps RNG control.
void st_sample_stratified(void* h, int64_t batch, const double* uniforms,
                          int64_t* idx_out, double* priority_out) {
  auto* t = static_cast<SumTree*>(h);
  double seg = t->tree[1] / static_cast<double>(batch);
  for (int64_t i = 0; i < batch; ++i) {
    double v = (static_cast<double>(i) + uniforms[i]) * seg;
    idx_out[i] = st_get_leaf(h, v, &priority_out[i]);
  }
}

// Checkpoint support: copy all leaves out / load leaves (rebuilding the
// internal nodes) and restore the ring state.
void st_get_leaves(void* h, double* out) {
  auto* t = static_cast<SumTree*>(h);
  for (int64_t i = 0; i < t->cap; ++i) out[i] = t->tree[t->cap + i];
}

void st_set_state(void* h, const double* leaves, int64_t cursor,
                  int64_t filled) {
  auto* t = static_cast<SumTree*>(h);
  for (int64_t i = 0; i < t->cap; ++i) {
    t->tree[t->cap + i] = leaves[i];
    t->maxt[t->cap + i] = leaves[i];
  }
  for (int64_t i = t->cap - 1; i >= 1; --i) {
    t->tree[i] = t->tree[2 * i] + t->tree[2 * i + 1];
    double l = t->maxt[2 * i], r = t->maxt[2 * i + 1];
    t->maxt[i] = l > r ? l : r;
  }
  t->cursor = cursor % t->cap;
  t->filled = filled < t->cap ? filled : t->cap;
}

}  // extern "C"
