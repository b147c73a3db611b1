// Continuous-batching slot scheduler core (C++), the port's copy of the
// JAX package's native core.
//
// Request admission, slot allocation and retirement bookkeeping for the
// continuous-batching decode loop: mustafar_tpu_torch/runtime/scheduler.py
// drives the model on the card, this core owns the host-side state machine.
// It refuses a request with no prompt, no new tokens or more tokens than a
// slot holds.  C ABI, bound with ctypes (native/__init__.py).
//
// Build: g++ -O2 -shared -fPIC -o _scheduler.so scheduler.cpp

#include <cstdint>
#include <deque>
#include <vector>

namespace {

struct Request {
  uint64_t uid;
  int32_t prompt_len;
  int32_t max_new;
};

struct Slot {
  bool active = false;
  uint64_t uid = 0;
  int32_t pos = 0;      // next write index (tokens so far)
  int32_t budget = 0;   // remaining new tokens
};

struct Scheduler {
  int32_t num_slots;
  int32_t max_seq_len;
  std::vector<Slot> slots;
  std::deque<Request> queue;
  // stats
  uint64_t admitted = 0;
  uint64_t finished = 0;
  uint64_t rejected = 0;
};

}  // namespace

extern "C" {

void* msched_create(int32_t num_slots, int32_t max_seq_len) {
  if (num_slots <= 0 || max_seq_len <= 0) return nullptr;
  auto* s = new Scheduler();
  s->num_slots = num_slots;
  s->max_seq_len = max_seq_len;
  s->slots.resize(num_slots);
  return s;
}

void msched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Returns 0 on success, -1 if the request can never fit (rejected).
int32_t msched_submit(void* h, uint64_t uid, int32_t prompt_len,
                      int32_t max_new) {
  auto* s = static_cast<Scheduler*>(h);
  if (prompt_len <= 0 || max_new <= 0 ||
      prompt_len + max_new > s->max_seq_len) {
    s->rejected++;
    return -1;
  }
  s->queue.push_back({uid, prompt_len, max_new});
  return 0;
}

// Admit queued requests into free slots (FCFS).  Writes up to *cap entries
// of (slot, uid, prompt_len, max_new) into the output arrays; returns count.
int32_t msched_fill(void* h, int32_t* out_slots, uint64_t* out_uids,
                    int32_t* out_prompt_lens, int32_t* out_max_new,
                    int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  int32_t n = 0;
  for (int32_t i = 0; i < s->num_slots && n < cap && !s->queue.empty(); ++i) {
    Slot& slot = s->slots[i];
    if (slot.active) continue;
    Request r = s->queue.front();
    s->queue.pop_front();
    slot.active = true;
    slot.uid = r.uid;
    slot.pos = r.prompt_len;  // caller bumps to prompt_len+1 after prefill
    slot.budget = r.max_new;
    out_slots[n] = i;
    out_uids[n] = r.uid;
    out_prompt_lens[n] = r.prompt_len;
    out_max_new[n] = r.max_new;
    s->admitted++;
    ++n;
  }
  return n;
}

// Record that slot `slot` produced a token (eos: 1 if it was EOS).
// Returns 1 if the slot retired (finished), 0 if still active, -1 on error.
int32_t msched_commit(void* h, int32_t slot, int32_t is_eos) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->num_slots || !s->slots[slot].active) return -1;
  Slot& sl = s->slots[slot];
  sl.pos += 1;
  sl.budget -= 1;
  if (is_eos || sl.budget <= 0 || sl.pos >= s->max_seq_len) {
    sl.active = false;
    sl.pos = 0;
    s->finished++;
    return 1;
  }
  return 0;
}

int32_t msched_num_active(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  int32_t n = 0;
  for (auto& sl : s->slots) n += sl.active ? 1 : 0;
  return n;
}

int32_t msched_num_queued(void* h) {
  return static_cast<int32_t>(static_cast<Scheduler*>(h)->queue.size());
}

void msched_active_mask(void* h, int32_t* out) {
  auto* s = static_cast<Scheduler*>(h);
  for (int32_t i = 0; i < s->num_slots; ++i) out[i] = s->slots[i].active;
}

void msched_positions(void* h, int32_t* out) {
  auto* s = static_cast<Scheduler*>(h);
  for (int32_t i = 0; i < s->num_slots; ++i) out[i] = s->slots[i].pos;
}

void msched_uids(void* h, uint64_t* out) {
  auto* s = static_cast<Scheduler*>(h);
  for (int32_t i = 0; i < s->num_slots; ++i)
    out[i] = s->slots[i].active ? s->slots[i].uid : 0;
}

void msched_stats(void* h, uint64_t* admitted, uint64_t* finished,
                  uint64_t* rejected) {
  auto* s = static_cast<Scheduler*>(h);
  *admitted = s->admitted;
  *finished = s->finished;
  *rejected = s->rejected;
}

}  // extern "C"
