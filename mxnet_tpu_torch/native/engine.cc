// Native host-side dependency engine of the PyTorch/CUDA port.
//
// The port's own copy of the JAX package's native/engine.cc (the
// reference's dependency scheduler: include/mxnet/engine.h:75-250,
// src/engine/threaded_engine.{h,cc}, threaded_engine_perdevice.cc,
// naive_engine.cc), under C symbols of its own (mxtt_engine_*) so a process
// that loads both libraries never binds one's entry points to the other's.
//
// Scope: *device* work is ordered by CUDA streams and graphs; this engine
// orders the host-side work they cannot see — checkpoint/file IO,
// data-pipeline stages, parameter-server updates, the serving dispatch and
// the decode steps, metric sinks. The semantics are the reference's:
// operations are closures tagged with const (read) and mutable (write)
// variable sets; conflicting ops serialize in push order, everything else
// runs concurrently on a worker pool.
//
// Dependency discipline (mirrors ThreadedVar's
// AppendRead/WriteDependency + CompleteRead/WriteDependency,
// threaded_engine.h:93-195): each Var keeps a FIFO of pending (op,is_write)
// entries plus counts of running readers / an active writer. Queue heads are
// granted when compatible; an op dispatches when ALL its vars have granted
// (atomic pending counter, the OprBlock wait count of threaded_engine.h:44).
//
// Engine types (MXNET_ENGINE_TYPE, src/engine/engine.cc:13-38):
//   0 = ThreadedEngine (worker pool, default)
//   1 = NaiveEngine    (synchronous execution in Push, for debugging —
//                       threaded_engine.h:326-338 tells users to do this)
//
// Profiling: every executed op records {name, thread, start_us, dur_us},
// dumpable as a chrome://tracing JSON via mxtt_engine_dump_profile — the
// analogue of src/engine/profiler.{h,cc} OprExecStat/DevStat.
//
// C ABI only (ctypes boundary, like include/mxnet/c_api.h).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

int64_t now_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             Clock::now().time_since_epoch())
      .count();
}

// Completion callback handed to async fns (CallbackOnComplete,
// include/mxnet/engine.h:37-54).
struct Opr;
class Engine;

typedef void (*OprFn)(void* param, void* on_complete);
typedef void (*DeleteFn)(void* param);

struct VarEntry {
  Opr* opr;
  bool is_write;
};

// ThreadedVar analogue (threaded_engine.h:93-195).
struct Var {
  std::deque<VarEntry> queue;
  int running_reads = 0;
  bool running_write = false;
};

struct Opr {
  OprFn fn;
  void* param;
  DeleteFn del;
  std::vector<int64_t> const_vars;
  std::vector<int64_t> mut_vars;
  std::atomic<int> pending{0};  // OprBlock::wait (threaded_engine.h:44-71)
  int priority = 0;
  std::string name;
  bool async = false;
  int64_t delete_var = -1;  // var to erase after completion (DeleteVariable)
  Engine* engine = nullptr;
  // NaiveEngine async support: completion just signals Push's wait.
  bool naive = false;
  std::mutex* naive_mu = nullptr;
  std::condition_variable* naive_cv = nullptr;
  bool* naive_done = nullptr;
};

struct ProfRecord {
  std::string name;
  uint32_t tid;
  int64_t start_us;
  int64_t dur_us;
};

struct ReadyCmp {
  bool operator()(Opr* a, Opr* b) const { return a->priority < b->priority; }
};

class Engine {
 public:
  Engine(int num_workers, int type) : type_(type) {
    if (num_workers <= 0) {
      unsigned hc = std::thread::hardware_concurrency();
      num_workers = hc > 2 ? static_cast<int>(hc / 2) : 2;
      if (num_workers > 8) num_workers = 8;
    }
    if (type_ == 0) {
      for (int i = 0; i < num_workers; ++i) {
        workers_.emplace_back([this, i] { WorkerLoop(i); });
      }
    }
  }

  ~Engine() {
    WaitForAll();
    {
      std::unique_lock<std::mutex> lk(ready_mu_);
      shutdown_ = true;
    }
    ready_cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int64_t NewVar() {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t id = next_var_++;
    vars_.emplace(id, Var{});
    return id;
  }

  // DeleteVariable semantics (engine.h:141-151): deletion is itself a write
  // op, so it happens after all pending uses.
  void DeleteVar(int64_t v) {
    Push(
        [](void*, void*) {}, nullptr, nullptr, nullptr, 0, &v, 1, 0,
        "delete_var", /*async=*/false, /*mark_delete=*/true);
  }

  void Push(OprFn fn, void* param, DeleteFn del, const int64_t* cvars,
            int ncvar, const int64_t* mvars, int nmvar, int priority,
            const char* name, bool async, bool mark_delete = false) {
    if (type_ == 1) {  // NaiveEngine: run inline (naive_engine.cc:16-191)
      int64_t t0 = now_us();
      if (async) {
        // synchronous semantics: block until the op's on_complete fires
        std::mutex m;
        std::condition_variable cv;
        bool done = false;
        Opr stack_op;
        stack_op.naive = true;
        stack_op.naive_mu = &m;
        stack_op.naive_cv = &cv;
        stack_op.naive_done = &done;
        fn(param, &stack_op);
        std::unique_lock<std::mutex> lk(m);
        cv.wait(lk, [&] { return done; });
      } else {
        fn(param, nullptr);  // sync fns ignore on_complete
      }
      Record(name ? name : "op", 0, t0);
      if (del) del(param);
      if (mark_delete) {
        std::lock_guard<std::mutex> lk(mu_);
        vars_.erase(mvars[0]);
      }
      return;
    }
    Opr* op = new Opr;
    op->fn = fn;
    op->param = param;
    op->del = del;
    op->priority = priority;
    op->name = name ? name : "op";
    op->engine = this;
    op->const_vars.assign(cvars, cvars + ncvar);
    op->mut_vars.assign(mvars, mvars + nmvar);
    op->async = async;
    if (mark_delete) op->delete_var = mvars[0];
    pending_total_.fetch_add(1);

    std::lock_guard<std::mutex> lk(mu_);
    op->pending.store(ncvar + nmvar + 1);
    for (int64_t v : op->const_vars) Append(v, op, false);
    for (int64_t v : op->mut_vars) Append(v, op, true);
    if (op->pending.fetch_sub(1) == 1) Enqueue(op);
  }

  // Called by async fns' completion, and by the worker for sync fns
  // (ThreadedEngine::OnComplete, threaded_engine.cc:314).
  void OnComplete(Opr* op) {
    if (op->naive) {  // stack-allocated op from the NaiveEngine async path
      std::lock_guard<std::mutex> lk(*op->naive_mu);
      *op->naive_done = true;
      op->naive_cv->notify_all();
      return;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (int64_t v : op->const_vars) CompleteRead(v);
      for (int64_t v : op->mut_vars) CompleteWrite(v);
      if (op->delete_var >= 0) vars_.erase(op->delete_var);
    }
    if (op->del) op->del(op->param);
    delete op;
    if (pending_total_.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(wait_mu_);
      wait_cv_.notify_all();
    }
  }

  void WaitForVar(int64_t v) {
    // WaitForVar (engine.h:183-190): push a read op and block on it.
    std::mutex m;
    std::condition_variable cv;
    bool done = false;
    struct Ctx {
      std::mutex* m;
      std::condition_variable* cv;
      bool* done;
    } ctx{&m, &cv, &done};
    Push(
        [](void* p, void*) {
          Ctx* c = static_cast<Ctx*>(p);
          std::lock_guard<std::mutex> lk(*c->m);
          *c->done = true;
          c->cv->notify_all();
        },
        &ctx, nullptr, &v, 1, nullptr, 0, 1 << 20, "wait_for_var", false);
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return done; });
  }

  void WaitForAll() {
    std::unique_lock<std::mutex> lk(wait_mu_);
    wait_cv_.wait(lk, [&] { return pending_total_.load() == 0; });
  }

  int PendingCount() { return pending_total_.load(); }

  // --- profiler ---------------------------------------------------------
  void SetProfiling(bool on) { profiling_ = on; }

  void Record(const std::string& name, uint32_t tid, int64_t t0) {
    if (!profiling_) return;
    std::lock_guard<std::mutex> lk(prof_mu_);
    prof_.push_back({name, tid, t0, now_us() - t0});
  }

  // Chrome trace JSON (src/engine/profiler.cc DumpProfile analogue).
  std::string DumpProfile() {
    std::lock_guard<std::mutex> lk(prof_mu_);
    std::string out = "{\"traceEvents\":[";
    bool first = true;
    for (auto& r : prof_) {
      if (!first) out += ",";
      first = false;
      char buf[512];
      snprintf(buf, sizeof(buf),
               "{\"name\":\"%s\",\"cat\":\"engine\",\"ph\":\"X\",\"ts\":%lld,"
               "\"dur\":%lld,\"pid\":0,\"tid\":%u}",
               r.name.c_str(), static_cast<long long>(r.start_us),
               static_cast<long long>(r.dur_us), r.tid);
      out += buf;
    }
    out += "]}";
    return out;
  }

  void ExecuteOpr(Opr* op, uint32_t tid) {
    int64_t t0 = now_us();
    // copy before fn: an async fn may invoke on_complete (deleting op)
    // before it returns
    bool async = op->async;
    std::string name = op->name;
    op->fn(op->param, op);  // on_complete handle = the Opr itself
    Record(name, tid, t0);
    if (!async) OnComplete(op);
  }

 private:
  void Append(int64_t v, Opr* op, bool is_write) {
    // AppendRead/WriteDependency (threaded_engine.h:109-143): try to grant
    // immediately if compatible with current holders AND nothing queued.
    Var& var = vars_[v];
    if (var.queue.empty()) {
      if (!is_write && !var.running_write) {
        ++var.running_reads;
        GrantOne(op);
        return;
      }
      if (is_write && !var.running_write && var.running_reads == 0) {
        var.running_write = true;
        GrantOne(op);
        return;
      }
    }
    var.queue.push_back({op, is_write});
  }

  void CompleteRead(int64_t v) {
    auto it = vars_.find(v);
    if (it == vars_.end()) return;
    Var& var = it->second;
    --var.running_reads;
    Advance(var);
  }

  void CompleteWrite(int64_t v) {
    auto it = vars_.find(v);
    if (it == vars_.end()) return;
    Var& var = it->second;
    var.running_write = false;
    Advance(var);
  }

  void Advance(Var& var) {
    // CompleteReadDependency/CompleteWriteDependency queue advance
    // (threaded_engine.h:146-195): grant maximal compatible prefix.
    while (!var.queue.empty()) {
      VarEntry e = var.queue.front();
      if (e.is_write) {
        if (var.running_reads == 0 && !var.running_write) {
          var.running_write = true;
          var.queue.pop_front();
          GrantOne(e.opr);
        }
        break;
      }
      if (var.running_write) break;
      ++var.running_reads;
      var.queue.pop_front();
      GrantOne(e.opr);
    }
  }

  void GrantOne(Opr* op) {
    if (op->pending.fetch_sub(1) == 1) Enqueue(op);
  }

  void Enqueue(Opr* op) {
    {
      std::lock_guard<std::mutex> lk(ready_mu_);
      ready_.push(op);
    }
    ready_cv_.notify_one();
  }

  void WorkerLoop(int tid) {
    for (;;) {
      Opr* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(ready_mu_);
        ready_cv_.wait(lk, [&] { return shutdown_ || !ready_.empty(); });
        if (shutdown_ && ready_.empty()) return;
        op = ready_.top();
        ready_.pop();
      }
      ExecuteOpr(op, static_cast<uint32_t>(tid));
    }
  }

  int type_;
  std::mutex mu_;  // guards vars_
  std::unordered_map<int64_t, Var> vars_;
  int64_t next_var_ = 1;

  std::mutex ready_mu_;
  std::condition_variable ready_cv_;
  std::priority_queue<Opr*, std::vector<Opr*>, ReadyCmp> ready_;
  bool shutdown_ = false;

  std::atomic<int> pending_total_{0};
  std::mutex wait_mu_;
  std::condition_variable wait_cv_;

  std::vector<std::thread> workers_;

  bool profiling_ = false;
  std::mutex prof_mu_;
  std::vector<ProfRecord> prof_;
};

}  // namespace

extern "C" {

void* mxtt_engine_create(int num_workers, int engine_type) {
  return new Engine(num_workers, engine_type);
}

void mxtt_engine_destroy(void* e) { delete static_cast<Engine*>(e); }

int64_t mxtt_engine_new_var(void* e) {
  return static_cast<Engine*>(e)->NewVar();
}

void mxtt_engine_delete_var(void* e, int64_t v) {
  static_cast<Engine*>(e)->DeleteVar(v);
}

// fn(param, on_complete): sync ops must ignore on_complete (the engine
// completes on return). Async ops must eventually call
// mxtt_engine_opr_complete(engine, on_complete) from any thread.
void mxtt_engine_push(void* e, void (*fn)(void*, void*), void* param,
              void (*del)(void*), const int64_t* const_vars, int n_const,
              const int64_t* mut_vars, int n_mut, int priority,
              const char* name, int is_async) {
  static_cast<Engine*>(e)->Push(fn, param, del, const_vars, n_const, mut_vars,
                                n_mut, priority, name, is_async != 0);
}

void mxtt_engine_opr_complete(void* e, void* on_complete) {
  static_cast<Engine*>(e)->OnComplete(static_cast<Opr*>(on_complete));
}

void mxtt_engine_wait_for_var(void* e, int64_t v) {
  static_cast<Engine*>(e)->WaitForVar(v);
}

void mxtt_engine_wait_for_all(void* e) {
  static_cast<Engine*>(e)->WaitForAll();
}

int mxtt_engine_pending(void* e) {
  return static_cast<Engine*>(e)->PendingCount();
}

void mxtt_engine_set_profiling(void* e, int on) {
  static_cast<Engine*>(e)->SetProfiling(on != 0);
}

// Returns length; if buf != null copies up to buf_len bytes.
int64_t mxtt_engine_dump_profile(void* e, char* buf, int64_t buf_len) {
  std::string s = static_cast<Engine*>(e)->DumpProfile();
  if (buf && buf_len > 0) {
    int64_t n = static_cast<int64_t>(s.size()) < buf_len - 1
                    ? static_cast<int64_t>(s.size())
                    : buf_len - 1;
    memcpy(buf, s.data(), n);
    buf[n] = 0;
  }
  return static_cast<int64_t>(s.size());
}

}  // extern "C"
