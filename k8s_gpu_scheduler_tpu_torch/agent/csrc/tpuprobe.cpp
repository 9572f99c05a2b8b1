// tpuprobe — the node agent's prober in the port: reads the node's
// accelerators and prints one JSON object per probe on stdout. The agent
// (k8s_gpu_scheduler_tpu_torch/agent/scrape.py) execs it with --once and
// parses that line. Its argv, output schema and exit codes are the JAX
// package's prober's, byte for byte, so either agent parses either prober.
//
// Probe sources, in order:
//   1. --fake FILE / TPUPROBE_FAKE: a JSON metrics file (the test seam),
//      passed through after validation.
//   2. TPUPROBE_DEV_GLOB, when set: one chip per matching device node,
//      utilization unknown (0); the device id is the name's trailing
//      integer (accel3 -> 3).
//   3. Otherwise NVML: the driver's libnvidia-ml.so.1 (TPUPROBE_NVML_LIB
//      overrides the path), opened with dlopen, with hand-declared
//      prototypes so no header is needed. One chip per NVML index:
//      duty_cycle = utilization.gpu / 100 (the share of the driver's last
//      sample window, 1/6 s to 1 s, in which a kernel ran), hbm_used and
//      hbm_total = nvmlMemory_t's used and total bytes (used may include
//      memory the driver reserves). NVML numbers devices in PCI bus order
//      and ignores CUDA_VISIBLE_DEVICES: the prober reports every device
//      of the node. It only reads: it sets no clock, MIG mode or
//      persistence setting.
// When no source finds a chip it prints {"chips":[]} and exits 1 (after a
// last look at /tmp/tpuprobe_fake.json). A missing library, a failed
// NVML call (named with nvmlErrorString on stderr) or NVML counting no
// device gives exit 1 with {"chips":[]} at once, with no last look: a
// broken node must never report idle chips.
//
// Output schema (one line):
//   {"chips":[{"device_id":N,"duty_cycle":F,"hbm_used":N,"hbm_total":N}]}
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <glob.h>
#include <string>
#include <unistd.h>
#include <vector>

namespace {

struct Chip {
  int device_id = 0;
  double duty_cycle = 0.0;
  long long hbm_used = 0;
  long long hbm_total = 0;
};

void emit(const std::vector<Chip>& chips) {
  std::string out = "{\"chips\":[";
  char buf[160];
  for (size_t i = 0; i < chips.size(); ++i) {
    const Chip& c = chips[i];
    snprintf(buf, sizeof buf,
             "%s{\"device_id\":%d,\"duty_cycle\":%.4f,\"hbm_used\":%lld,"
             "\"hbm_total\":%lld}",
             i ? "," : "", c.device_id, c.duty_cycle, c.hbm_used, c.hbm_total);
    out += buf;
  }
  out += "]}\n";
  fputs(out.c_str(), stdout);
  fflush(stdout);
}

// Minimal field scanner for the fake file: pulls every {...} object's
// device_id/duty_cycle/hbm_* numbers. Tolerant of whitespace/ordering;
// anything unparsable yields no chips (exit 1 below).
bool parse_fake(const std::string& text, std::vector<Chip>* chips) {
  size_t pos = 0;
  while ((pos = text.find("\"device_id\"", pos)) != std::string::npos) {
    Chip c;
    auto grab = [&](const char* key, double* out_d, long long* out_ll) {
      size_t start = text.rfind('{', pos);
      size_t end = text.find('}', pos);
      if (start == std::string::npos || end == std::string::npos) return;
      size_t k = text.find(key, start);
      if (k == std::string::npos || k > end) return;
      size_t colon = text.find(':', k);
      if (colon == std::string::npos || colon > end) return;
      const char* s = text.c_str() + colon + 1;
      if (out_d) *out_d = strtod(s, nullptr);
      if (out_ll) *out_ll = strtoll(s, nullptr, 10);
    };
    double id = 0;
    grab("\"device_id\"", &id, nullptr);
    c.device_id = static_cast<int>(id);
    grab("\"duty_cycle\"", &c.duty_cycle, nullptr);
    grab("\"hbm_used\"", nullptr, &c.hbm_used);
    grab("\"hbm_total\"", nullptr, &c.hbm_total);
    chips->push_back(c);
    pos = text.find('}', pos);
    if (pos == std::string::npos) break;
  }
  return !chips->empty();
}

bool probe_fake(const char* path, std::vector<Chip>* chips) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  std::string text;
  char buf[4096];
  size_t n;
  while ((n = fread(buf, 1, sizeof buf, f)) > 0) text.append(buf, n);
  fclose(f);
  return parse_fake(text, chips);
}

bool probe_devnodes(const char* pattern, std::vector<Chip>* chips) {
  glob_t g;
  if (glob(pattern, 0, nullptr, &g) != 0) return false;
  for (size_t i = 0; i < g.gl_pathc; ++i) {
    Chip c;
    // device id = trailing integer of the node name (accel3 -> 3)
    const char* name = g.gl_pathv[i];
    const char* p = name + strlen(name);
    while (p > name && isdigit(static_cast<unsigned char>(p[-1]))) --p;
    c.device_id = atoi(p);
    chips->push_back(c);
  }
  globfree(&g);
  return !chips->empty();
}

// NVML's types and entry points as nvml.h declares them.
typedef int nvmlReturn_t;  // 0 = NVML_SUCCESS
typedef struct nvmlDevice_st* nvmlDevice_t;
struct nvmlUtilization_t {
  unsigned int gpu;     // percent of the sample window a kernel ran
  unsigned int memory;  // percent of it device memory was read or written
};
struct nvmlMemory_t {
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
};

struct Nvml {
  nvmlReturn_t (*init)();
  nvmlReturn_t (*count)(unsigned int*);
  nvmlReturn_t (*handle)(unsigned int, nvmlDevice_t*);
  nvmlReturn_t (*utilization)(nvmlDevice_t, nvmlUtilization_t*);
  nvmlReturn_t (*memory)(nvmlDevice_t, nvmlMemory_t*);
  const char* (*error_string)(nvmlReturn_t);
  nvmlReturn_t (*shutdown)();
};

bool nvml_failed(const Nvml& nvml, const char* call, nvmlReturn_t rc) {
  const char* text = nvml.error_string(rc);
  fprintf(stderr, "tpuprobe: %s failed: %s (%d)\n", call,
          text ? text : "unknown error", rc);
  return true;
}

// One chip per NVML device. Returns false with *failed set when the
// library is missing, a call fails or NVML counts no device (each
// reported on stderr): a node whose NVML sees no card is broken, and the
// /tmp last resort must not stand in for it.
bool probe_nvml(std::vector<Chip>* chips, bool* failed) {
  const char* path = getenv("TPUPROBE_NVML_LIB");
  if (!path || !*path) path = "libnvidia-ml.so.1";
  void* lib = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (!lib) {
    fprintf(stderr, "tpuprobe: dlopen %s failed: %s\n", path, dlerror());
    *failed = true;
    return false;
  }
  Nvml nvml;
  struct {
    const char* name;
    void** slot;
  } syms[] = {
      {"nvmlInit_v2", reinterpret_cast<void**>(&nvml.init)},
      {"nvmlDeviceGetCount_v2", reinterpret_cast<void**>(&nvml.count)},
      {"nvmlDeviceGetHandleByIndex_v2",
       reinterpret_cast<void**>(&nvml.handle)},
      {"nvmlDeviceGetUtilizationRates",
       reinterpret_cast<void**>(&nvml.utilization)},
      {"nvmlDeviceGetMemoryInfo", reinterpret_cast<void**>(&nvml.memory)},
      {"nvmlErrorString", reinterpret_cast<void**>(&nvml.error_string)},
      {"nvmlShutdown", reinterpret_cast<void**>(&nvml.shutdown)},
  };
  for (const auto& s : syms) {
    *s.slot = dlsym(lib, s.name);
    if (!*s.slot) {
      fprintf(stderr, "tpuprobe: dlsym %s in %s failed: %s\n", s.name, path,
              dlerror());
      dlclose(lib);
      *failed = true;
      return false;
    }
  }
  nvmlReturn_t rc = nvml.init();
  if (rc != 0) {
    *failed = nvml_failed(nvml, "nvmlInit_v2", rc);
    dlclose(lib);
    return false;
  }
  unsigned int n = 0;
  rc = nvml.count(&n);
  if (rc != 0) {
    *failed = nvml_failed(nvml, "nvmlDeviceGetCount_v2", rc);
  } else if (n == 0) {
    fputs("tpuprobe: nvmlDeviceGetCount_v2 counted no device\n", stderr);
    *failed = true;
  }
  for (unsigned int i = 0; i < n && !*failed; ++i) {
    nvmlDevice_t dev = nullptr;
    nvmlUtilization_t util = {0, 0};
    nvmlMemory_t mem = {0, 0, 0};
    if ((rc = nvml.handle(i, &dev)) != 0) {
      *failed = nvml_failed(nvml, "nvmlDeviceGetHandleByIndex_v2", rc);
    } else if ((rc = nvml.utilization(dev, &util)) != 0) {
      *failed = nvml_failed(nvml, "nvmlDeviceGetUtilizationRates", rc);
    } else if ((rc = nvml.memory(dev, &mem)) != 0) {
      *failed = nvml_failed(nvml, "nvmlDeviceGetMemoryInfo", rc);
    } else {
      Chip c;
      c.device_id = static_cast<int>(i);
      c.duty_cycle = util.gpu / 100.0;
      c.hbm_used = static_cast<long long>(mem.used);
      c.hbm_total = static_cast<long long>(mem.total);
      chips->push_back(c);
    }
  }
  nvml.shutdown();
  dlclose(lib);
  if (*failed) chips->clear();
  return !chips->empty();
}

}  // namespace

int main(int argc, char** argv) {
  const char* fake = getenv("TPUPROBE_FAKE");
  const char* dev_glob = getenv("TPUPROBE_DEV_GLOB");
  int interval_s = 0;  // 0 = --once
  for (int i = 1; i < argc; ++i) {
    if (!strcmp(argv[i], "--fake") && i + 1 < argc) fake = argv[++i];
    else if (!strcmp(argv[i], "--interval") && i + 1 < argc)
      interval_s = atoi(argv[++i]);
    else if (!strcmp(argv[i], "--once")) interval_s = 0;
    else if (!strcmp(argv[i], "--help")) {
      puts("tpuprobe [--once] [--interval SECONDS] [--fake FILE]");
      return 0;
    }
  }

  do {
    std::vector<Chip> chips;
    bool failed = false;  // an NVML error: reported, never masked
    bool ok = fake       ? probe_fake(fake, &chips)
              : dev_glob ? probe_devnodes(dev_glob, &chips)
                         : probe_nvml(&chips, &failed);
    if (!ok && !fake && !failed)
      ok = probe_fake("/tmp/tpuprobe_fake.json", &chips);
    if (!ok) {
      fputs("{\"chips\":[]}\n", stdout);
      fflush(stdout);
      if (interval_s == 0) return 1;
    } else {
      emit(chips);
    }
    if (interval_s > 0) sleep(interval_s);
  } while (interval_s > 0);
  return 0;
}
