// zvnative — native runtime components of zerovox_tpu_torch.
//
// The port's own copy of native/zvnative.cpp (the JAX package's), built by
// zerovox_tpu_torch/io/native.py with the same flags into the port's build
// directory: the GGUF tensor reader (the counterpart of ggml's C reader) and
// the PCM16 WAV writer (libsndfile's SF_FORMAT_WAV | SF_FORMAT_PCM_16).
// Exposed as a C ABI consumed from Python via ctypes.
//
// Design: the hot path is bulk tensor bytes (hundreds of MB); this library
// mmaps the checkpoint and hands out zero-copy pointers plus a fused
// f16->f32 widening kernel.  Metadata (KV section, a few KB) stays in the
// pure-Python reader.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kGgufMagic = 0x46554747;  // "GGUF"
constexpr uint64_t kDefaultAlignment = 32;

struct TensorInfo {
    std::string name;
    int32_t ggml_type = 0;
    int32_t n_dims = 0;
    int64_t ne[4] = {1, 1, 1, 1};  // ggml order: innermost first
    uint64_t offset = 0;           // relative to data section
    uint64_t nbytes = 0;
};

// bytes-per-element for the non-quantized ggml types zerovox uses
int64_t type_size_bytes(int32_t t) {
    switch (t) {
        case 0: return 4;   // F32
        case 1: return 2;   // F16
        case 24: return 1;  // I8
        case 25: return 2;  // I16
        case 26: return 4;  // I32
        case 27: return 8;  // I64
        case 28: return 8;  // F64
        case 30: return 2;  // BF16
        default: return -1; // quantized: caller must size via directory delta
    }
}

struct Reader {
    const uint8_t* p;
    uint64_t size;
    uint64_t pos = 0;
    bool ok = true;

    // All bounds checks are written in subtractive form (n > size - pos,
    // with pos <= size as invariant) so attacker-controlled uint64 lengths
    // from a crafted/corrupt file cannot wrap the comparison.
    template <typename T> T get() {
        if (sizeof(T) > size - pos) { ok = false; return T{}; }
        T v;
        std::memcpy(&v, p + pos, sizeof(T));
        pos += sizeof(T);
        return v;
    }
    std::string get_string() {
        uint64_t n = get<uint64_t>();
        if (!ok || n > size - pos) { ok = false; return {}; }
        std::string s(reinterpret_cast<const char*>(p + pos), n);
        pos += n;
        return s;
    }
    bool skip(uint64_t n) {
        if (n > size - pos) { ok = false; return false; }
        pos += n;
        return true;
    }
};

// Skip one KV value of the given GGUF type.  When out_uint is non-null and
// the value is an unsigned/signed integer, also report it (used to capture
// general.alignment without parsing the full KV section).
bool skip_value(Reader& r, int32_t vtype, uint64_t* out_uint = nullptr) {
    switch (vtype) {
        case 0: case 1: case 7: {                       // u8/i8/bool
            uint8_t v = r.get<uint8_t>();
            if (out_uint) *out_uint = v;
            return r.ok;
        }
        case 2: case 3: {                               // u16/i16
            uint16_t v = r.get<uint16_t>();
            if (out_uint) *out_uint = v;
            return r.ok;
        }
        case 4: case 5: {                               // u32/i32
            uint32_t v = r.get<uint32_t>();
            if (out_uint) *out_uint = v;
            return r.ok;
        }
        case 6: return r.skip(4);                       // f32
        case 10: case 11: {                             // u64/i64
            uint64_t v = r.get<uint64_t>();
            if (out_uint) *out_uint = v;
            return r.ok;
        }
        case 12: return r.skip(8);                      // f64
        case 8: { r.get_string(); return r.ok; }        // string
        case 9: {                                       // array
            int32_t et = r.get<int32_t>();
            uint64_t n = r.get<uint64_t>();
            if (!r.ok) return false;
            for (uint64_t i = 0; i < n && r.ok; i++)
                if (!skip_value(r, et)) return false;
            return r.ok;
        }
        default: return false;
    }
}

}  // namespace

struct zv_gguf {
    int fd = -1;
    const uint8_t* map = nullptr;
    uint64_t map_size = 0;
    uint64_t data_offset = 0;
    std::vector<TensorInfo> tensors;
    std::unordered_map<std::string, size_t> by_name;
};

static void set_err(char* errbuf, int errlen, const std::string& msg) {
    if (errbuf && errlen > 0) {
        std::snprintf(errbuf, (size_t)errlen, "%s", msg.c_str());
    }
}

extern "C" {

zv_gguf* zv_gguf_open(const char* path, char* errbuf, int errlen) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) {
        set_err(errbuf, errlen, std::string("open failed: ") + path);
        return nullptr;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size <= 0) {
        set_err(errbuf, errlen, "fstat failed");
        ::close(fd);
        return nullptr;
    }
    uint64_t size = (uint64_t)st.st_size;
    const void* map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) {
        set_err(errbuf, errlen, "mmap failed");
        ::close(fd);
        return nullptr;
    }

    Reader r{reinterpret_cast<const uint8_t*>(map), size};
    uint32_t magic = r.get<uint32_t>();
    uint32_t version = r.get<uint32_t>();
    if (!r.ok || magic != kGgufMagic || (version != 2 && version != 3)) {
        set_err(errbuf, errlen, "bad GGUF magic/version");
        munmap(const_cast<void*>(map), size);
        ::close(fd);
        return nullptr;
    }
    int64_t n_tensors = r.get<int64_t>();
    int64_t n_kv = r.get<int64_t>();
    if (!r.ok || n_tensors < 0 || n_kv < 0) {
        set_err(errbuf, errlen, "truncated header");
        munmap(const_cast<void*>(map), size);
        ::close(fd);
        return nullptr;
    }

    // Walk the KV section (Python parses full metadata); honor
    // general.alignment — hardcoding 32 would silently misplace the data
    // section of any file written with a different alignment.
    uint64_t alignment = kDefaultAlignment;
    for (int64_t i = 0; i < n_kv && r.ok; i++) {
        std::string key = r.get_string();
        int32_t vt = r.get<int32_t>();
        if (!r.ok) break;
        uint64_t uval = 0;
        uint64_t* want = (key == "general.alignment") ? &uval : nullptr;
        if (!skip_value(r, vt, want)) { r.ok = false; break; }
        if (want) {
            // must be a nonzero power of two (ggml requirement)
            if (uval == 0 || (uval & (uval - 1)) != 0) {
                set_err(errbuf, errlen, "invalid general.alignment");
                munmap(const_cast<void*>(map), size);
                ::close(fd);
                return nullptr;
            }
            alignment = uval;
        }
    }

    auto* g = new zv_gguf();
    g->fd = fd;
    g->map = reinterpret_cast<const uint8_t*>(map);
    g->map_size = size;
    g->tensors.reserve((size_t)n_tensors);

    for (int64_t i = 0; i < n_tensors && r.ok; i++) {
        TensorInfo t;
        t.name = r.get_string();
        t.n_dims = (int32_t)r.get<uint32_t>();
        if (t.n_dims < 0 || t.n_dims > 4) { r.ok = false; break; }
        uint64_t nelem = 1;
        for (int32_t d = 0; d < t.n_dims; d++) {
            uint64_t e = r.get<uint64_t>();
            if (e > (uint64_t)INT64_MAX ||
                __builtin_mul_overflow(nelem, e, &nelem)) {
                r.ok = false;
                break;
            }
            t.ne[d] = (int64_t)e;
        }
        if (!r.ok) break;
        t.ggml_type = r.get<int32_t>();
        t.offset = r.get<uint64_t>();
        int64_t esz = type_size_bytes(t.ggml_type);
        if (esz > 0) {
            if (__builtin_mul_overflow(nelem, (uint64_t)esz, &t.nbytes)) {
                r.ok = false;
                break;
            }
        } else {
            t.nbytes = 0;
        }
        g->by_name.emplace(t.name, g->tensors.size());
        g->tensors.push_back(std::move(t));
    }
    if (!r.ok) {
        set_err(errbuf, errlen, "truncated tensor directory");
        zv_gguf* tmp = g;
        munmap(const_cast<void*>(map), size);
        ::close(fd);
        delete tmp;
        return nullptr;
    }

    uint64_t pad = (alignment - r.pos % alignment) % alignment;
    g->data_offset = r.pos + pad;
    if (g->data_offset > g->map_size) {
        set_err(errbuf, errlen, "data section starts past end of file");
        munmap(const_cast<void*>(map), size);
        ::close(fd);
        delete g;
        return nullptr;
    }

    // bounds-check every tensor against the file size (subtractive form —
    // offset/nbytes come from the file and may be adversarial)
    uint64_t data_size = g->map_size - g->data_offset;
    for (const auto& t : g->tensors) {
        if (t.offset > data_size || t.nbytes > data_size - t.offset) {
            set_err(errbuf, errlen, "tensor data out of bounds: " + t.name);
            munmap(const_cast<void*>(map), size);
            ::close(fd);
            delete g;
            return nullptr;
        }
    }
    return g;
}

void zv_gguf_close(zv_gguf* g) {
    if (!g) return;
    if (g->map) munmap(const_cast<void*>(reinterpret_cast<const void*>(g->map)), g->map_size);
    if (g->fd >= 0) ::close(g->fd);
    delete g;
}

int64_t zv_gguf_n_tensors(zv_gguf* g) { return (int64_t)g->tensors.size(); }

const char* zv_gguf_tensor_name(zv_gguf* g, int64_t i) {
    if (i < 0 || (size_t)i >= g->tensors.size()) return nullptr;
    return g->tensors[(size_t)i].name.c_str();
}

int zv_gguf_tensor_info(zv_gguf* g, const char* name, int32_t* ggml_type,
                        int32_t* n_dims, int64_t* ne4, int64_t* nbytes) {
    auto it = g->by_name.find(name);
    if (it == g->by_name.end()) return -1;
    const TensorInfo& t = g->tensors[it->second];
    if (ggml_type) *ggml_type = t.ggml_type;
    if (n_dims) *n_dims = t.n_dims;
    if (ne4) for (int d = 0; d < 4; d++) ne4[d] = t.ne[d];
    if (nbytes) *nbytes = (int64_t)t.nbytes;
    return 0;
}

const void* zv_gguf_tensor_data(zv_gguf* g, const char* name) {
    auto it = g->by_name.find(name);
    if (it == g->by_name.end()) return nullptr;
    return g->map + g->data_offset + g->tensors[it->second].offset;
}

// Bulk f16 -> f32 widening (bit-exact, handles subnormals/inf/nan).
void zv_f16_to_f32(const uint16_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        uint16_t h = src[i];
        uint32_t sign = (uint32_t)(h & 0x8000) << 16;
        uint32_t exp = (h >> 10) & 0x1f;
        uint32_t mant = h & 0x3ff;
        uint32_t f;
        if (exp == 0) {
            if (mant == 0) {
                f = sign;
            } else {  // subnormal: normalize
                int shift = 0;
                while (!(mant & 0x400)) { mant <<= 1; shift++; }
                mant &= 0x3ff;
                f = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
            }
        } else if (exp == 31) {
            f = sign | 0x7f800000u | (mant << 13);
        } else {
            f = sign | ((exp - 15 + 127) << 23) | (mant << 13);
        }
        std::memcpy(&dst[i], &f, 4);
    }
}

// Bulk bf16 -> f32 widening.
void zv_bf16_to_f32(const uint16_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        uint32_t f = (uint32_t)src[i] << 16;
        std::memcpy(&dst[i], &f, 4);
    }
}

// 16-bit PCM mono WAV writer (matches the reference's libsndfile output
// format: SF_FORMAT_WAV | SF_FORMAT_PCM_16).
int zv_wav_write_pcm16(const char* path, const float* data, int64_t n,
                       int32_t rate) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;

    std::vector<int16_t> pcm((size_t)n);
    for (int64_t i = 0; i < n; i++) {
        float x = data[i];
        if (x > 1.0f) x = 1.0f;
        if (x < -1.0f) x = -1.0f;
        pcm[(size_t)i] = (int16_t)(x * 32767.0f);
    }
    uint32_t data_len = (uint32_t)(n * 2);
    uint32_t riff_len = 36 + data_len;
    uint32_t byte_rate = (uint32_t)rate * 2;
    uint16_t block_align = 2, bits = 16, fmt = 1, channels = 1;
    uint32_t fmt_len = 16;

    bool ok = true;
    ok = ok && std::fwrite("RIFF", 1, 4, f) == 4;
    ok = ok && std::fwrite(&riff_len, 4, 1, f) == 1;
    ok = ok && std::fwrite("WAVE", 1, 4, f) == 4;
    ok = ok && std::fwrite("fmt ", 1, 4, f) == 4;
    ok = ok && std::fwrite(&fmt_len, 4, 1, f) == 1;
    ok = ok && std::fwrite(&fmt, 2, 1, f) == 1;
    ok = ok && std::fwrite(&channels, 2, 1, f) == 1;
    ok = ok && std::fwrite(&rate, 4, 1, f) == 1;
    ok = ok && std::fwrite(&byte_rate, 4, 1, f) == 1;
    ok = ok && std::fwrite(&block_align, 2, 1, f) == 1;
    ok = ok && std::fwrite(&bits, 2, 1, f) == 1;
    ok = ok && std::fwrite("data", 1, 4, f) == 4;
    ok = ok && std::fwrite(&data_len, 4, 1, f) == 1;
    ok = ok && std::fwrite(pcm.data(), 2, (size_t)n, f) == (size_t)n;
    std::fclose(f);
    return ok ? 0 : -2;
}

}  // extern "C"
