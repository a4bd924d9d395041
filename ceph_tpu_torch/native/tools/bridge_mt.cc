// Multithreaded bridge round trip: loads plugin=cuda via the dlopen
// registry and drives encode/decode from TWO concurrent threads plus the
// (initializing) main thread, then prints the port's counters as one
// JSON line.  Guards the embedded interpreter's GIL discipline: the
// interpreter's start leaves the init thread holding the GIL, and unless
// the bridge releases it every other thread deadlocks in
// PyGILState_Ensure — run it under a timeout, so that a regression shows
// up as a hang turned failure.
//
//   bridge_mt [DIR [DEVICE]]
//
// DIR holds libec_cuda.so (default "."), DEVICE is the profile's
// device= (default cuda).  Each round trip codes a 1 MiB object with RS
// k=8 m=3: chunks of 128 KiB, which the port runs on its device tier.
// The last line of stdout is
//   {"ec_device_calls": N, "ec_host_calls": N, "launches": {...},
//    "bridge": {...}}
// read through the same interpreter the plugin runs: global_perf()'s
// counters and ops/launches.py::launch_counts(); "bridge" is the
// plugin's own entry timing (ceph_tpu_cuda_bridge_stats, all zeros
// unless CEPH_TPU_BRIDGE_STATS is set).

#include <Python.h>
#include <dlfcn.h>

#include <atomic>
#include <cstdio>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "ceph_tpu_ec/plugin.h"

using namespace ceph_tpu_ec;

static std::atomic<int> failures{0};

static void roundtrip(const ErasureCodeInterfaceRef &ec, unsigned seed,
                      int iters) {
  std::mt19937 rng(seed);
  const unsigned k = ec->get_data_chunk_count();
  const unsigned n = ec->get_chunk_count();
  for (int it = 0; it < iters; it++) {
    std::string data((1 << 20) + 64 * seed + it, '\0');
    for (auto &c : data) c = (char)(rng() & 0xff);
    std::set<int> want;
    for (unsigned i = 0; i < n; i++) want.insert((int)i);
    ChunkMap encoded;
    if (ec->encode(want, data, &encoded) != 0 || encoded.size() != n) {
      std::fprintf(stderr, "thread %u iter %d: encode failed\n", seed, it);
      failures++;
      return;
    }
    int chunk_size = (int)encoded.begin()->second.size();
    // erase two chunks (one data, one parity)
    ChunkMap avail = encoded;
    int e0 = (int)(rng() % k), e1 = (int)(k + rng() % (n - k));
    avail.erase(e0);
    avail.erase(e1);
    ChunkMap decoded;
    std::set<int> want_read{e0, e1};
    if (ec->decode(want_read, avail, &decoded, chunk_size) != 0) {
      std::fprintf(stderr, "thread %u iter %d: decode failed\n", seed, it);
      failures++;
      return;
    }
    if (decoded[e0] != encoded[e0] || decoded[e1] != encoded[e1]) {
      std::fprintf(stderr, "thread %u iter %d: mismatch on %d/%d\n", seed,
                   it, e0, e1);
      failures++;
      return;
    }
  }
}

// json.dumps of the port's counters, evaluated in the plugin's
// interpreter (the GIL taken like any other entry)
static std::string counters_json() {
  static const char *src =
      "import json\n"
      "from ceph_tpu_torch.ops.launches import launch_counts\n"
      "from ceph_tpu_torch.utils.perf import global_perf\n"
      "_p = global_perf()\n"
      "result = json.dumps({'ec_device_calls': _p.get('ec_device_calls'),\n"
      "                     'ec_host_calls': _p.get('ec_host_calls'),\n"
      "                     'launches': launch_counts()})\n";
  std::string out;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *globals = PyDict_New();
  PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins());
  PyObject *r = PyRun_String(src, Py_file_input, globals, globals);
  PyObject *s = r ? PyDict_GetItemString(globals, "result") : nullptr;
  const char *u = s ? PyUnicode_AsUTF8(s) : nullptr;
  if (u) {
    out = u;
  } else {
    PyErr_Print();
  }
  Py_XDECREF(r);
  Py_DECREF(globals);
  PyGILState_Release(g);
  return out;
}

int main(int argc, char **argv) {
  std::string dir = argc > 1 ? argv[1] : ".";
  std::string device = argc > 2 ? argv[2] : "cuda";
  ErasureCodeProfile profile{{"backend", "jerasure"},
                             {"k", "8"},
                             {"m", "3"},
                             {"technique", "reed_sol_van"},
                             {"device", device}};
  ErasureCodeInterfaceRef ec;
  std::string ss;
  // init (and the embedded interpreter's start) happens on this thread
  int r = ErasureCodePluginRegistry::instance().factory("cuda", dir, profile,
                                                        &ec, &ss);
  if (r != 0) {
    std::fprintf(stderr, "factory(cuda) failed: %d %s\n", r, ss.c_str());
    return 1;
  }
  // concurrent round trips on two OTHER threads while the init thread
  // sits in join() executing no Python: both workers need the GIL the
  // init thread would still be holding without the bridge's release
  std::thread t1(roundtrip, ec, 1, 2);
  std::thread t2(roundtrip, ec, 2, 2);
  t1.join();
  t2.join();
  // ...and the init thread can still use the instance afterwards
  roundtrip(ec, 0, 2);
  if (failures.load()) {
    std::fprintf(stderr, "FAIL: %d thread(s) failed\n", failures.load());
    return 1;
  }
  std::string counters = counters_json();
  if (counters.empty()) {
    std::fprintf(stderr, "FAIL: cannot read the port's counters\n");
    return 1;
  }
  // the registry loaded libec_cuda.so RTLD_GLOBAL: its symbols resolve
  using StatsFn = size_t (*)(char *, size_t);
  auto stats = (StatsFn)dlsym(RTLD_DEFAULT, "ceph_tpu_cuda_bridge_stats");
  if (!stats) {
    std::fprintf(stderr, "FAIL: the plugin exports no bridge stats\n");
    return 1;
  }
  std::string bridge(stats(nullptr, 0) + 1, '\0');
  bridge.resize(stats(&bridge[0], bridge.size()));
  counters.back() = ',';  // counters ends in '}'
  counters += " \"bridge\": " + bridge + "}";
  std::printf("bridge multithreaded round-trip OK\n%s\n", counters.c_str());
  return 0;
}
