// libec_cuda — the card bridge plugin (plugin=cuda).
//
// Implements the native ErasureCodeInterface by forwarding chunk batches
// to the PyTorch/CUDA port (ceph_tpu_torch.codes) through an embedded
// CPython interpreter: an unmodified native consumer (the benchmark and
// file tools here; ECBackend's role upstream) selects `plugin=cuda` via
// the dlopen registry, and every encode_chunks/decode lands on the
// port's code instance, whose region math runs on the card's kernels
// (ops/csrc/*.cu).  One process, no IPC; every entry takes the GIL
// through PyGILState_*, so the consumer's threads may call in freely.
//
// Profile keys: backend=<python plugin name> (default jerasure);
// device=cuda|cuda:N|cpu (default: the card; without one init fails with
// the port's NoDeviceError, and only device=cpu runs on the CPU).  Every
// other key is forwarded verbatim to the Python plugin's profile.
// Environment:
//   CEPH_TPU_PYROOT — directory to prepend to sys.path, the one holding
//                     ceph_tpu_torch/ (default: compile-time
//                     CEPH_TPU_PYROOT_DEFAULT, the checkout it was built
//                     from)
//   CEPH_TPU_BRIDGE_STATS — a file: time every encode/decode entry (see
//                     BridgeStats) and, when an instance is destroyed,
//                     append one JSON line to it: {"bridge": the sums,
//                     "port": the port's counters read in this
//                     interpreter}.  Unset: nothing is timed.
// Compile-time CEPH_TPU_PYTHON_DEFAULT names the python executable the
// plugin was built with: the embedded interpreter takes it as its
// program name, so it finds that python's site-packages (torch).

#include <Python.h>

#include <atomic>
#include <cctype>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <set>
#include <string>

#include "ceph_tpu_ec/plugin.h"

namespace ceph_tpu_ec {

namespace {

std::string py_error();

// Start the interpreter as the build's python would (its program name,
// so its prefix and site-packages), with no signal handlers: the
// consumer owns the process's signals.  On success this thread holds
// the GIL; on failure there is no interpreter and the message says why.
std::string init_interpreter() {
#ifdef CEPH_TPU_PYTHON_DEFAULT
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                        CEPH_TPU_PYTHON_DEFAULT);
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st))
    return std::string(st.func ? st.func : "Py_InitializeFromConfig") +
           ": " + (st.err_msg ? st.err_msg : "failed");
#else
  Py_InitializeEx(0);
#endif
  return "";
}

// one interpreter per process; never finalized (the registry keeps the
// plugin .so resident — disable_dlclose — so this is process-lifetime)
int ensure_python(std::string *ss) {
  static std::mutex init_lock;
  // setup_done tracks the BOOTSTRAP (the path insert), not interpreter
  // liveness: a failed bootstrap is re-attempted on the next init()
  // instead of latching a half-configured interpreter behind
  // Py_IsInitialized() (re-inserting the path is harmless).
  static bool setup_done = false;
  std::lock_guard<std::mutex> g(init_lock);
  if (setup_done) return 0;
  const bool fresh = !Py_IsInitialized();
  PyGILState_STATE gil{};
  if (fresh) {
    std::string err = init_interpreter();  // this thread holds the GIL
    if (!err.empty()) {
      if (ss) *ss = "bridge: python init failed: " + err;
      return -EIO;
    }
  } else {
    gil = PyGILState_Ensure();  // bootstrap retry on a live interpreter
  }
  const char *root = std::getenv("CEPH_TPU_PYROOT");
#ifdef CEPH_TPU_PYROOT_DEFAULT
  if (!root) root = CEPH_TPU_PYROOT_DEFAULT;
#endif
  // Quote-safe bootstrap: values go through the C API as OBJECTS, never
  // interpolated into python source — a pyroot containing ' " \ or
  // spaces must work.
  int rc = 0;
  std::string detail;
  if (root) {
    PyObject *sys_path = PySys_GetObject("path");  // borrowed
    PyObject *p = PyUnicode_DecodeFSDefault(root);
    if (!sys_path || !p || PyList_Insert(sys_path, 0, p) != 0) {
      detail = "sys.path insert: " + py_error();
      rc = -1;
    }
    Py_XDECREF(p);
  }
  // Release the GIL so every entry point (this thread's included) can
  // take it via PyGILState_Ensure — the consumer's data path
  // (ECBackend role) is multithreaded, and a held GIL would deadlock
  // the second thread.  The fresh-init thread state is intentionally
  // never restored: the interpreter lives for the process and all
  // access is PyGILState_*.
  if (fresh)
    PyEval_SaveThread();
  else
    PyGILState_Release(gil);
  if (rc != 0) {
    if (ss) *ss = "bridge: python bootstrap failed: " + detail;
    return -EIO;
  }
  setup_done = true;
  return 0;
}

// fetch the python exception as "Type: message" (never throw across
// the ABI); the type name lets the consumer tell NoDeviceError from a
// profile error
std::string py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *u = PyUnicode_AsUTF8(s);
      if (u) msg = u;
      Py_DECREF(s);
    }
  }
  if (type && PyType_Check(type))
    msg = std::string(((PyTypeObject *)type)->tp_name) + ": " + msg;
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  PyErr_Clear();
  return msg;
}

// The bridge's own time, per entry and op (encode, decode), in ns on the
// steady clock: taking the GIL, copying the chunks into python objects,
// the port's call (PyObject_CallMethod), and copying its result into the
// consumer's strings.  A call is "first" when its op's chunk pattern
// (wanted | available) is new in this process: a decode's first use of
// an erasure pattern sets up its decode matrix there.
class BridgeStats {
 public:
  enum Seg { kGil, kIn, kCall, kOut, kSegs };
  static const char *const kSegNames[kSegs];
  static const char *const kOpNames[2];

  static BridgeStats &instance() {
    static BridgeStats s;
    return s;
  }
  const char *path() const { return path_; }
  bool on() const { return path_ != nullptr; }

  void record(int op, const std::string &pattern, const uint64_t *seg) {
    Op &o = ops_[op];
    bool first;
    {
      std::lock_guard<std::mutex> g(lock_);
      first = seen_.insert(std::to_string(op) + ":" + pattern).second;
    }
    uint64_t total = 0;
    for (int i = 0; i < kSegs; i++) {
      o.seg_ns[i] += seg[i];
      total += seg[i];
    }
    o.calls++;
    if (first) {
      o.first++;
      o.first_ns += total;
    }
  }

  // {"encode": {"calls": N, "first": N, "first_ns": N, "gil_ns": N,
  //  "in_ns": N, "call_ns": N, "out_ns": N}, "decode": {...}}
  std::string json() const {
    std::string out = "{";
    for (int op = 0; op < 2; op++) {
      const Op &o = ops_[op];
      out += std::string(op ? ", " : "") + "\"" + kOpNames[op] +
             "\": {\"calls\": " + std::to_string(o.calls.load()) +
             ", \"first\": " + std::to_string(o.first.load()) +
             ", \"first_ns\": " + std::to_string(o.first_ns.load());
      for (int i = 0; i < kSegs; i++)
        out += std::string(", \"") + kSegNames[i] +
               "_ns\": " + std::to_string(o.seg_ns[i].load());
      out += "}";
    }
    return out + "}";
  }

 private:
  struct Op {
    std::atomic<uint64_t> calls{0}, first{0}, first_ns{0};
    std::atomic<uint64_t> seg_ns[kSegs] = {};
  };
  BridgeStats() : path_(std::getenv("CEPH_TPU_BRIDGE_STATS")) {
    if (path_ && !*path_) path_ = nullptr;
  }
  const char *path_;
  Op ops_[2];
  mutable std::mutex lock_;
  std::set<std::string> seen_;
};

const char *const BridgeStats::kSegNames[] = {"gil", "in", "call", "out"};
const char *const BridgeStats::kOpNames[] = {"encode", "decode"};

// One entry's laps: each mark() adds the time since the last one to its
// segment; nothing is read from the clock when the stats are off.
class CallTimer {
 public:
  CallTimer() : on_(BridgeStats::instance().on()) {
    if (on_) t_ = std::chrono::steady_clock::now();
  }
  void mark(BridgeStats::Seg s) {
    if (!on_) return;
    auto now = std::chrono::steady_clock::now();
    seg_[s] += (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
                   now - t_).count();
    t_ = now;
  }
  // op 0 encode, 1 decode; pattern: the wanted and available chunk ids
  void record(int op, const std::set<int> &want, const ChunkMap *avail) {
    if (!on_) return;
    std::string pattern;
    for (int c : want) pattern += std::to_string(c) + ",";
    pattern += "|";
    if (avail)
      for (auto &kv : *avail) pattern += std::to_string(kv.first) + ",";
    BridgeStats::instance().record(op, pattern, seg_);
  }

 private:
  bool on_;
  std::chrono::steady_clock::time_point t_;
  uint64_t seg_[BridgeStats::kSegs] = {};
};

// json.dumps of the port's counters in this interpreter (GIL held):
// global_perf()'s device and host calls, the kernels' launch counts and
// the kernel setups; "null" when they cannot be read
std::string port_counters_json() {
  static const char *src =
      "import json\n"
      "from ceph_tpu_torch.ops.launches import launch_counts\n"
      "from ceph_tpu_torch.telemetry.metrics import kernel_setups\n"
      "from ceph_tpu_torch.utils.perf import global_perf\n"
      "_p = global_perf()\n"
      "result = json.dumps({'ec_device_calls': _p.get('ec_device_calls'),\n"
      "                     'ec_host_calls': _p.get('ec_host_calls'),\n"
      "                     'kernel_setups': kernel_setups(),\n"
      "                     'launches': launch_counts()})\n";
  std::string out = "null";
  PyObject *globals = PyDict_New();
  PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins());
  PyObject *r = PyRun_String(src, Py_file_input, globals, globals);
  PyObject *s = r ? PyDict_GetItemString(globals, "result") : nullptr;
  const char *u = s ? PyUnicode_AsUTF8(s) : nullptr;
  if (u)
    out = u;
  else
    PyErr_Clear();
  Py_XDECREF(r);
  Py_DECREF(globals);
  return out;
}

// cuda, cuda:N or cpu
bool device_ok(const std::string &d) {
  if (d == "cpu" || d == "cuda") return true;
  if (d.rfind("cuda:", 0) != 0 || d.size() == 5) return false;
  for (size_t i = 5; i < d.size(); i++)
    if (!std::isdigit((unsigned char)d[i])) return false;
  return true;
}

}  // namespace

class CudaErasureCode : public ErasureCode {
 public:
  ~CudaErasureCode() override {
    if (ec_) {
      PyGILState_STATE g = PyGILState_Ensure();
      Py_DECREF(ec_);
      const BridgeStats &stats = BridgeStats::instance();
      if (stats.on()) {
        std::string line = "{\"bridge\": " + stats.json() +
                           ", \"port\": " + port_counters_json() + "}\n";
        if (FILE *f = std::fopen(stats.path(), "a")) {
          std::fwrite(line.data(), 1, line.size(), f);
          std::fclose(f);
        }
      }
      PyGILState_Release(g);
    }
  }

  int parse(const ErasureCodeProfile &, std::string *) override { return 0; }

  int init(const ErasureCodeProfile &profile, std::string *ss) override {
    int r = ensure_python(ss);
    if (r) return r;
    PyGILState_STATE g = PyGILState_Ensure();
    r = init_locked(profile, ss);
    PyGILState_Release(g);
    return r;
  }

  unsigned int get_chunk_size(unsigned int stripe_width) const override {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *res = PyObject_CallMethod(ec_, "get_chunk_size", "I",
                                        stripe_width);
    unsigned v = 0;
    if (res) {
      v = (unsigned)PyLong_AsUnsignedLong(res);
      Py_DECREF(res);
    } else {
      PyErr_Clear();
    }
    PyGILState_Release(g);
    return v;
  }

  int get_sub_chunk_count() const override { return sub_chunk_count_; }

  int encode_chunks(const std::set<int> &want, ChunkMap *encoded) override {
    CallTimer timer;
    PyGILState_STATE g = PyGILState_Ensure();
    timer.mark(BridgeStats::kGil);
    PyObject *chunks = PyDict_New();
    for (unsigned i = 0; i < k_; i++) {
      const std::string &buf = encoded->at((int)i);
      PyObject *b = PyBytes_FromStringAndSize(buf.data(), buf.size());
      PyObject *key = PyLong_FromLong((long)i);
      PyDict_SetItem(chunks, key, b);
      Py_DECREF(key);
      Py_DECREF(b);
    }
    PyObject *wantset = PySet_New(nullptr);
    for (unsigned i = 0; i < k_ + m_; i++) {
      PyObject *key = PyLong_FromLong((long)i);
      PySet_Add(wantset, key);
      Py_DECREF(key);
    }
    timer.mark(BridgeStats::kIn);
    PyObject *res =
        PyObject_CallMethod(ec_, "encode_chunks", "OO", wantset, chunks);
    timer.mark(BridgeStats::kCall);
    Py_DECREF(wantset);
    Py_DECREF(chunks);
    int r = copy_out(res, encoded);
    PyGILState_Release(g);
    timer.mark(BridgeStats::kOut);
    timer.record(0, want, nullptr);
    return r;
  }

  int decode_chunks(const std::set<int> &want, const ChunkMap &chunks,
                    ChunkMap *decoded) override {
    CallTimer timer;
    PyGILState_STATE g = PyGILState_Ensure();
    timer.mark(BridgeStats::kGil);
    PyObject *avail = PyDict_New();
    Py_ssize_t chunk_size = 0;
    for (auto &kv : chunks) {
      chunk_size = (Py_ssize_t)kv.second.size();
      PyObject *b =
          PyBytes_FromStringAndSize(kv.second.data(), kv.second.size());
      PyObject *key = PyLong_FromLong(kv.first);
      PyDict_SetItem(avail, key, b);
      Py_DECREF(key);
      Py_DECREF(b);
    }
    PyObject *wantset = PySet_New(nullptr);
    for (int c : want) {
      PyObject *key = PyLong_FromLong(c);
      PySet_Add(wantset, key);
      Py_DECREF(key);
    }
    timer.mark(BridgeStats::kIn);
    PyObject *res = PyObject_CallMethod(ec_, "decode", "OOn", wantset,
                                        avail, chunk_size);
    timer.mark(BridgeStats::kCall);
    Py_DECREF(wantset);
    Py_DECREF(avail);
    int r = copy_out(res, decoded);
    PyGILState_Release(g);
    timer.mark(BridgeStats::kOut);
    timer.record(1, want, &chunks);
    return r;
  }

  int minimum_to_decode(
      const std::set<int> &want_to_read, const std::set<int> &available,
      std::map<int, std::vector<std::pair<int, int>>> *minimum) override {
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *w = PySet_New(nullptr);
    for (int c : want_to_read) {
      PyObject *k = PyLong_FromLong(c);
      PySet_Add(w, k);
      Py_DECREF(k);
    }
    PyObject *a = PySet_New(nullptr);
    for (int c : available) {
      PyObject *k = PyLong_FromLong(c);
      PySet_Add(a, k);
      Py_DECREF(k);
    }
    PyObject *res =
        PyObject_CallMethod(ec_, "minimum_to_decode", "OO", w, a);
    Py_DECREF(w);
    Py_DECREF(a);
    int r = 0;
    if (!res) {
      PyErr_Clear();
      r = -EIO;
    } else {
      PyObject *key = nullptr, *val = nullptr;
      Py_ssize_t pos = 0;
      while (PyDict_Next(res, &pos, &key, &val)) {
        auto &runs = (*minimum)[(int)PyLong_AsLong(key)];
        PyObject *it = PyObject_GetIter(val);
        PyObject *pair;
        while (it && (pair = PyIter_Next(it))) {
          long off = PyLong_AsLong(PyTuple_GetItem(pair, 0));
          long len = PyLong_AsLong(PyTuple_GetItem(pair, 1));
          runs.emplace_back((int)off, (int)len);
          Py_DECREF(pair);
        }
        Py_XDECREF(it);
      }
      Py_DECREF(res);
    }
    PyGILState_Release(g);
    return r;
  }

 private:
  int init_locked(const ErasureCodeProfile &profile, std::string *ss) {
    std::string backend = "jerasure";
    std::string device;  // empty: the card
    PyObject *prof = PyDict_New();
    for (auto &kv : profile) {
      if (kv.first == "backend") {
        backend = kv.second;
        continue;
      }
      if (kv.first == "device") {
        device = kv.second;
        continue;
      }
      if (kv.first == "plugin" || kv.first == "directory") continue;
      PyObject *v = PyUnicode_FromString(kv.second.c_str());
      PyDict_SetItemString(prof, kv.first.c_str(), v);
      Py_DECREF(v);
    }
    if (!device.empty() && !device_ok(device)) {
      Py_DECREF(prof);
      if (ss)
        *ss = "bridge: ValueError: device " + device +
              " is neither cuda nor cpu";
      return -EINVAL;
    }
    PyObject *mod = PyImport_ImportModule("ceph_tpu_torch.codes.registry");
    if (!mod) {
      Py_DECREF(prof);
      if (ss) *ss = "bridge: import ceph_tpu_torch failed: " + py_error();
      return -EIO;
    }
    PyObject *cls =
        PyObject_GetAttrString(mod, "ErasureCodePluginRegistry");
    Py_DECREF(mod);
    PyObject *registry =
        cls ? PyObject_CallMethod(cls, "instance", nullptr) : nullptr;
    Py_XDECREF(cls);
    if (!registry) {
      Py_DECREF(prof);
      if (ss) *ss = "bridge: registry unavailable: " + py_error();
      return -EIO;
    }
    // factory(backend, profile, device=...)
    PyObject *factory = PyObject_GetAttrString(registry, "factory");
    Py_DECREF(registry);
    PyObject *args = factory ? Py_BuildValue("(sO)", backend.c_str(), prof)
                             : nullptr;
    PyObject *kwargs = PyDict_New();
    PyObject *dev = device.empty() ? Py_NewRef(Py_None)
                                   : PyUnicode_FromString(device.c_str());
    PyDict_SetItemString(kwargs, "device", dev);
    Py_DECREF(dev);
    ec_ = args ? PyObject_Call(factory, args, kwargs) : nullptr;
    Py_XDECREF(args);
    Py_DECREF(kwargs);
    Py_XDECREF(factory);
    Py_DECREF(prof);
    if (!ec_) {
      if (ss) *ss = "bridge: factory(" + backend + ") failed: " + py_error();
      return -EINVAL;
    }
    profile_ = profile;
    PyObject *kk = PyObject_CallMethod(ec_, "get_data_chunk_count", nullptr);
    PyObject *nn = PyObject_CallMethod(ec_, "get_chunk_count", nullptr);
    PyObject *sc = PyObject_CallMethod(ec_, "get_sub_chunk_count", nullptr);
    if (!kk || !nn || !sc) {
      if (ss) *ss = "bridge: counts failed: " + py_error();
      Py_XDECREF(kk);
      Py_XDECREF(nn);
      Py_XDECREF(sc);
      return -EIO;
    }
    k_ = (unsigned)PyLong_AsLong(kk);
    m_ = (unsigned)PyLong_AsLong(nn) - k_;
    sub_chunk_count_ = (int)PyLong_AsLong(sc);
    Py_DECREF(kk);
    Py_DECREF(nn);
    Py_DECREF(sc);
    return 0;
  }

  int copy_out(PyObject *res, ChunkMap *out) {
    if (!res) {
      PyErr_Clear();
      return -EIO;
    }
    PyObject *key = nullptr, *val = nullptr;
    Py_ssize_t pos = 0;
    while (PyDict_Next(res, &pos, &key, &val)) {
      char *data = nullptr;
      Py_ssize_t len = 0;
      if (PyBytes_AsStringAndSize(val, &data, &len) == 0)
        (*out)[(int)PyLong_AsLong(key)] = std::string(data, (size_t)len);
    }
    Py_DECREF(res);
    return 0;
  }

  PyObject *ec_ = nullptr;
  int sub_chunk_count_ = 1;
};

class ErasureCodePluginCuda : public ErasureCodePlugin {
 public:
  int factory(const std::string &directory, const ErasureCodeProfile &profile,
              ErasureCodeInterfaceRef *erasure_code,
              std::string *ss) override {
    (void)directory;
    auto ec = std::make_shared<CudaErasureCode>();
    int r = ec->init(profile, ss);
    if (r) return r;
    *erasure_code = ec;
    return 0;
  }
};

}  // namespace ceph_tpu_ec

// the native ABI's version string (native/src/plugin.cc's gate), not the
// Python port's
extern "C" const char __erasure_code_version[] = "ceph_tpu 0.1";

// BridgeStats::json() into buf (NUL-terminated, cut to len); returns the
// JSON's length.  All zeros unless CEPH_TPU_BRIDGE_STATS is set.
extern "C" size_t ceph_tpu_cuda_bridge_stats(char *buf, size_t len) {
  std::string s = ceph_tpu_ec::BridgeStats::instance().json();
  if (buf && len) {
    size_t n = s.size() < len - 1 ? s.size() : len - 1;
    std::memcpy(buf, s.data(), n);
    buf[n] = '\0';
  }
  return s.size();
}

extern "C" int __erasure_code_init(const char *plugin_name,
                                   const char *directory) {
  (void)directory;
  return ceph_tpu_ec::ErasureCodePluginRegistry::instance().add(
      plugin_name, new ceph_tpu_ec::ErasureCodePluginCuda());
}
