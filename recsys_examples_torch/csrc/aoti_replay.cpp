// Standalone C++ replay of the exported HSTU ranking dense forward, with no
// Python in the serving process.
//
// Counterpart of csrc/pjrt_replay.cpp (which replays the JAX package's
// StableHLO export through the PJRT C API): this binary loads the
// AOTInductor package that inference/export.py builds on the card
// (dense_fwd.aoti.pt2) with torch::inductor::AOTIModelPackageLoader, feeds
// it the inputs the replay spec lists, and runs the forward.
//
//   aoti_replay --package dense_fwd.aoti.pt2 --spec replay_spec.txt [--dry-run]
//
// The inputs go to the device the package was compiled for, which the
// package records in its metadata (AOTI_DEVICE_KEY).
//
// Spec format (one line per entry, written by export.py
// `write_replay_artifacts`; the same as pjrt_replay's):
//   input <name> <dtype> <d0,d1,...>     dtype in {f32,bf16,f16,f64,s64,s32,
//                                        s16,s8,u64,u32,u16,u8,pred};
//                                        scalar = "-"
//   data <relative-path>                 optional raw blob: concatenated
//                                        row-major input payloads in order;
//                                        the missing tail is zeros
// `--dry-run` parses the spec and the blob and prints
// {"mode": "dry-run", "inputs": N, ...} without loading the package. A run
// prints one JSON line: the outputs' shapes, the first output's sum and max
// (in fp64), and the median of kIters timed calls (ms, each ended by a
// device synchronisation).
//
// Built at first use by inference/export.py `build_aoti_replay` ($CXX, c++
// or g++, against torch.utils.cpp_extension's include and library paths,
// an rpath to torch's lib) into recsys_examples_torch/_build/.

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iterator>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr int kIters = 20;

struct InputSpec {
  std::string name;
  std::string dtype;
  std::vector<int64_t> dims;
  size_t bytes = 0;
};

struct Spec {
  std::vector<InputSpec> inputs;
  std::string data_path;  // optional, relative to the spec file
};

bool dtype_of(const std::string& d, at::ScalarType* out, int* width) {
  static const struct {
    const char* name;
    at::ScalarType type;
    int width;
  } table[] = {
      {"f32", at::kFloat, 4},    {"bf16", at::kBFloat16, 2}, {"f16", at::kHalf, 2},
      {"f64", at::kDouble, 8},   {"s64", at::kLong, 8},      {"s32", at::kInt, 4},
      {"s16", at::kShort, 2},    {"s8", at::kChar, 1},       {"u64", at::kUInt64, 8},
      {"u32", at::kUInt32, 4},   {"u16", at::kUInt16, 2},    {"u8", at::kByte, 1},
      {"pred", at::kBool, 1},
  };
  for (const auto& e : table) {
    if (d == e.name) {
      *out = e.type;
      *width = e.width;
      return true;
    }
  }
  return false;
}

bool parse_spec(const std::string& path, Spec* out, std::string* err) {
  std::ifstream f(path);
  if (!f) {
    *err = "cannot open spec: " + path;
    return false;
  }
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    std::string kind;
    ss >> kind;
    if (kind == "data") {
      ss >> out->data_path;
    } else if (kind == "input") {
      InputSpec in;
      std::string dims;
      ss >> in.name >> in.dtype >> dims;
      at::ScalarType type;
      int w = 0;
      if (in.dtype.empty() || dims.empty()) {
        *err = "malformed input line: " + line;
        return false;
      }
      if (!dtype_of(in.dtype, &type, &w)) {
        *err = "unknown dtype '" + in.dtype + "' in: " + line;
        return false;
      }
      size_t n = 1;
      if (dims != "-") {
        std::istringstream ds(dims);
        std::string tok;
        while (std::getline(ds, tok, ',')) {
          if (tok.empty()) continue;
          in.dims.push_back(std::stoll(tok));
          n *= static_cast<size_t>(in.dims.back());
        }
      }
      in.bytes = n * static_cast<size_t>(w);
      out->inputs.push_back(std::move(in));
    }
  }
  if (out->inputs.empty()) {
    *err = "spec has no inputs";
    return false;
  }
  return true;
}

std::string dir_of(const std::string& path) {
  size_t slash = path.find_last_of('/');
  return slash == std::string::npos ? std::string(".") : path.substr(0, slash);
}

// The blob's bytes, or an empty vector when the spec names none.
bool read_blob(const Spec& spec, const std::string& spec_path, std::vector<char>* blob,
               std::string* err) {
  if (spec.data_path.empty()) return true;
  std::string p = spec.data_path[0] == '/' ? spec.data_path
                                           : dir_of(spec_path) + "/" + spec.data_path;
  std::ifstream f(p, std::ios::binary);
  if (!f) {
    *err = "cannot open data: " + p;
    return false;
  }
  blob->assign(std::istreambuf_iterator<char>(f), std::istreambuf_iterator<char>());
  size_t total = 0;
  for (const auto& in : spec.inputs) total += in.bytes;
  if (blob->size() > total) {
    *err = "data holds " + std::to_string(blob->size()) + " bytes, the inputs " +
           std::to_string(total);
    return false;
  }
  return true;
}

std::string shape_json(const at::Tensor& t) {
  std::string s = "[";
  for (int64_t i = 0; i < t.dim(); ++i) {
    if (i) s += ", ";
    s += std::to_string(t.size(i));
  }
  return s + "]";
}

int usage() {
  std::fprintf(stderr,
               "usage: aoti_replay --package P.pt2 --spec replay_spec.txt [--dry-run]\n");
  return 2;
}

}  // namespace

int main(int argc, char** argv) {
  std::string package, spec_path;
  bool dry_run = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--dry-run") {
      dry_run = true;
    } else if (i + 1 < argc && a == "--package") {
      package = argv[++i];
    } else if (i + 1 < argc && a == "--spec") {
      spec_path = argv[++i];
    } else {
      return usage();
    }
  }
  if (spec_path.empty() || (!dry_run && package.empty())) return usage();

  Spec spec;
  std::string err;
  std::vector<char> blob;
  if (!parse_spec(spec_path, &spec, &err) || !read_blob(spec, spec_path, &blob, &err)) {
    std::fprintf(stderr, "aoti_replay: %s\n", err.c_str());
    return 1;
  }
  size_t total = 0;
  for (const auto& in : spec.inputs) total += in.bytes;
  if (dry_run) {
    std::printf("{\"mode\": \"dry-run\", \"inputs\": %zu, \"input_bytes\": %zu, "
                "\"data_bytes\": %zu}\n",
                spec.inputs.size(), total, blob.size());
    return 0;
  }

  try {
    torch::inductor::AOTIModelPackageLoader loader(package);
    auto meta = loader.get_metadata();
    auto key = meta.find("AOTI_DEVICE_KEY");
    if (key == meta.end()) {
      std::fprintf(stderr, "aoti_replay: the package records no device (AOTI_DEVICE_KEY)\n");
      return 1;
    }
    const std::string device = key->second;
    c10::Device dev(device);
    std::vector<at::Tensor> inputs;
    size_t off = 0;
    for (const auto& in : spec.inputs) {
      at::ScalarType type;
      int w = 0;
      dtype_of(in.dtype, &type, &w);
      at::Tensor t = at::zeros(in.dims, at::TensorOptions().dtype(type));
      size_t n = std::min(in.bytes, blob.size() > off ? blob.size() - off : 0);
      if (n) std::memcpy(t.data_ptr(), blob.data() + off, n);
      off += in.bytes;
      inputs.push_back(t.to(dev));
    }
    auto sync = [&] {
      if (dev.is_cuda()) torch::cuda::synchronize();
    };
    std::vector<at::Tensor> outs = loader.run(inputs);
    sync();
    std::vector<double> ms;
    for (int i = 0; i < kIters; ++i) {
      auto t0 = std::chrono::steady_clock::now();
      outs = loader.run(inputs);
      sync();
      ms.push_back(std::chrono::duration<double, std::milli>(
                       std::chrono::steady_clock::now() - t0)
                       .count());
    }
    std::sort(ms.begin(), ms.end());
    at::Tensor first = outs.at(0).to(at::kCPU, at::kDouble);
    std::string shapes = "[";
    for (size_t i = 0; i < outs.size(); ++i) {
      if (i) shapes += ", ";
      shapes += shape_json(outs[i]);
    }
    shapes += "]";
    std::printf("{\"mode\": \"run\", \"device\": \"%s\", \"inputs\": %zu, \"outputs\": %s, "
                "\"logits_sum\": %.17g, \"logits_max\": %.17g, \"iters\": %d, "
                "\"median_ms\": %.6f}\n",
                device.c_str(), inputs.size(), shapes.c_str(),
                first.sum().item<double>(), first.max().item<double>(), kIters,
                ms[ms.size() / 2]);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_replay: %s\n", e.what());
    return 1;
  }
  return 0;
}
