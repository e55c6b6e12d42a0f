// C ABI acoustics binding — the game-engine integration surface.
//
// The reference exposes the acoustics engine to Unity as flat extern "C"
// exports (reference ProjectPlaneverb/PlaneverbUnityPluginAPI/
// PlaneverbUnity.cpp:25-136). Here the engine is a Python host process
// driving a CUDA card, reachable over the newline-delimited JSON TCP
// protocol of planeverb_tpu_torch.server (the JAX package's protocol, byte
// for byte; this file is a copy of its pv_engine_client.cpp that differs in
// comments only). This library gives engines the same flat C surface:
// each export marshals its scalars into one JSON request, sends it, and
// parses the scalar reply — no Python, no JSON library, no dependencies
// beyond POSIX sockets.
//
// Exports mirror PlaneverbUnity.cpp: Init/Exit, Emit/UpdateEmission/
// EndEmission, Add/Update/RemoveGeometry, SetListenerPosition, GetOutput,
// plus Step/WaitIteration for engines that drive the loop explicitly.
// All functions take an opaque client handle from PlaneverbConnect (the
// reference uses a process-global singleton; a handle keeps multiple
// engine instances possible).

#include <cerrno>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct Client {
    int fd = -1;
    std::string rxbuf;
};

// --- tiny line-oriented socket I/O -------------------------------------

bool send_all(Client* c, const std::string& line) {
    const char* p = line.data();
    size_t n = line.size();
    while (n > 0) {
        // MSG_NOSIGNAL: a dropped server must fail the call, not deliver
        // SIGPIPE into the host game-engine process
        ssize_t w = ::send(c->fd, p, n, MSG_NOSIGNAL);
        if (w <= 0) return false;
        p += w;
        n -= static_cast<size_t>(w);
    }
    return true;
}

bool recv_line(Client* c, std::string* out) {
    for (;;) {
        size_t nl = c->rxbuf.find('\n');
        if (nl != std::string::npos) {
            out->assign(c->rxbuf, 0, nl);
            c->rxbuf.erase(0, nl + 1);
            return true;
        }
        char buf[4096];
        ssize_t r = ::recv(c->fd, buf, sizeof buf, 0);
        if (r <= 0) return false;
        c->rxbuf.append(buf, static_cast<size_t>(r));
    }
}

bool roundtrip(void* handle, const std::string& req, std::string* resp) {
    Client* c = static_cast<Client*>(handle);
    if (c == nullptr || c->fd < 0) return false;
    if (!send_all(c, req + "\n")) return false;
    return recv_line(c, resp);
}

// --- minimal JSON scalar extraction (protocol replies are flat) ----------

// finds `"key":` and parses the number (or first two numbers of an array)
bool find_key(const std::string& s, const char* key, size_t* pos) {
    std::string needle = std::string("\"") + key + "\":";
    size_t at = s.find(needle);
    if (at == std::string::npos) return false;
    *pos = at + needle.size();
    return true;
}

bool json_number(const std::string& s, const char* key, double* out) {
    size_t pos;
    if (!find_key(s, key, &pos)) return false;
    while (pos < s.size() && (s[pos] == ' ' || s[pos] == '[')) pos++;
    char* end = nullptr;
    double v = strtod(s.c_str() + pos, &end);
    if (end == s.c_str() + pos) return false;
    *out = v;
    return true;
}

bool json_pair(const std::string& s, const char* key, double* a, double* b) {
    size_t pos;
    if (!find_key(s, key, &pos)) return false;
    while (pos < s.size() && (s[pos] == ' ' || s[pos] == '[')) pos++;
    char* end = nullptr;
    *a = strtod(s.c_str() + pos, &end);
    if (end == s.c_str() + pos) return false;
    pos = static_cast<size_t>(end - s.c_str());
    while (pos < s.size() && (s[pos] == ',' || s[pos] == ' ')) pos++;
    *b = strtod(s.c_str() + pos, &end);
    return end != s.c_str() + pos;
}

bool json_true(const std::string& s, const char* key) {
    size_t pos;
    if (!find_key(s, key, &pos)) return false;
    while (pos < s.size() && s[pos] == ' ') pos++;
    return s.compare(pos, 4, "true") == 0;
}

std::string fmt(double v) {
    char buf[40];
    snprintf(buf, sizeof buf, "%.9g", v);
    return buf;
}

int reply_id(void* c, const std::string& req) {
    std::string resp;
    if (!roundtrip(c, req, &resp) || !json_true(resp, "ok")) return -1;
    double id;
    return json_number(resp, "id", &id) ? static_cast<int>(id) : -1;
}

void fire(void* c, const std::string& req) {
    std::string resp;
    roundtrip(c, req, &resp);
}

}  // namespace

extern "C" {

// Mirrors PlaneverbOutput (reference PvTypes.h:63-71 / PlaneverbUnity.cpp
// GetOutput marshalling): occlusion -1 = invalid sentinel.
struct PlaneverbOutputC {
    float occlusion;
    float wetGain;
    float rt60;
    float lowpass;
    float directionX;
    float directionY;
    float sourceDirectivityX;
    float sourceDirectivityY;
};

void* PlaneverbConnect(const char* host, int port) {
    // getaddrinfo: accepts hostnames ("localhost") and IPv4/IPv6 literals
    char portstr[16];
    snprintf(portstr, sizeof portstr, "%d", port);
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(host, portstr, &hints, &res) != 0 || res == nullptr)
        return nullptr;
    int fd = -1;
    for (addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
        fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
        ::close(fd);
        fd = -1;
    }
    freeaddrinfo(res);
    if (fd < 0) return nullptr;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    Client* c = new Client;
    c->fd = fd;
    return c;
}

void PlaneverbDisconnect(void* h) {
    Client* c = static_cast<Client*>(h);
    if (c == nullptr) return;
    std::string resp;
    roundtrip(h, "{\"cmd\":\"bye\"}", &resp);
    if (c->fd >= 0) ::close(c->fd);
    delete c;
}

// returns the simulation sampling rate fs, or -1 on failure.
// background != 0 spawns the server-side simulation loop (the reference's
// BackgroundProcessor); 0 leaves stepping to PlaneverbStep so reads never
// race an in-flight iteration's older listener snapshot.
int PlaneverbInit(void* c, float sizeX, float sizeY, int resolution,
                  float offsetX, float offsetY, int background) {
    std::string resp;
    std::string req = std::string("{\"cmd\":\"init\",\"grid_size_x\":") +
        fmt(sizeX) + ",\"grid_size_y\":" + fmt(sizeY) +
        ",\"grid_resolution\":" + fmt(resolution) +
        ",\"grid_offset_x\":" + fmt(offsetX) +
        ",\"grid_offset_y\":" + fmt(offsetY) +
        ",\"background\":" + (background ? "true" : "false") + "}";
    if (!roundtrip(c, req, &resp) || !json_true(resp, "ok")) return -1;
    double fs;
    return json_number(resp, "fs", &fs) ? static_cast<int>(fs) : -1;
}

void PlaneverbExit(void* c) { fire(c, "{\"cmd\":\"exit\"}"); }

int PlaneverbEmit(void* c, float x, float y, float z) {
    return reply_id(c, std::string("{\"cmd\":\"emit\",\"x\":") + fmt(x) +
                       ",\"y\":" + fmt(y) + ",\"z\":" + fmt(z) + "}");
}

// Emit with the emit-time attributes the reference keeps on its Unity
// component (PlaneverbEmitter.cs:21-24,89-96): facing vector, volume in dB,
// directivity pattern index. PlaneverbEmit above stays the reference-ABI
// position-only form.
int PlaneverbEmitEx(void* c, float x, float y, float z,
                    float fx, float fy, float fz,
                    float volumeDb, int pattern) {
    return reply_id(c, std::string("{\"cmd\":\"emit\",\"x\":") + fmt(x) +
                       ",\"y\":" + fmt(y) + ",\"z\":" + fmt(z) +
                       ",\"forward\":[" + fmt(fx) + "," + fmt(fy) + "," +
                       fmt(fz) + "],\"volume_db\":" + fmt(volumeDb) +
                       ",\"pattern\":" + fmt(pattern) + "}");
}

void PlaneverbUpdateEmission(void* c, int id, float x, float y, float z) {
    fire(c, std::string("{\"cmd\":\"update_emission\",\"id\":") + fmt(id) +
            ",\"x\":" + fmt(x) + ",\"y\":" + fmt(y) + ",\"z\":" + fmt(z) + "}");
}

void PlaneverbEndEmission(void* c, int id) {
    fire(c, std::string("{\"cmd\":\"end_emission\",\"id\":") + fmt(id) + "}");
}

int PlaneverbAddGeometry(void* c, float x, float y, float width, float height,
                         float absorption) {
    return reply_id(c, std::string("{\"cmd\":\"add_geometry\",\"x\":") +
                       fmt(x) + ",\"y\":" + fmt(y) + ",\"width\":" +
                       fmt(width) + ",\"height\":" + fmt(height) +
                       ",\"absorption\":" + fmt(absorption) + "}");
}

void PlaneverbUpdateGeometry(void* c, int id, float x, float y, float width,
                             float height, float absorption) {
    fire(c, std::string("{\"cmd\":\"update_geometry\",\"id\":") + fmt(id) +
            ",\"x\":" + fmt(x) + ",\"y\":" + fmt(y) + ",\"width\":" +
            fmt(width) + ",\"height\":" + fmt(height) +
            ",\"absorption\":" + fmt(absorption) + "}");
}

void PlaneverbRemoveGeometry(void* c, int id) {
    fire(c, std::string("{\"cmd\":\"remove_geometry\",\"id\":") + fmt(id) + "}");
}

void PlaneverbSetListenerPosition(void* c, float x, float y, float z) {
    fire(c, std::string("{\"cmd\":\"set_listener_position\",\"x\":") + fmt(x) +
            ",\"y\":" + fmt(y) + ",\"z\":" + fmt(z) + "}");
}

// runs one synchronous sim+analyze iteration; returns the iteration count
int PlaneverbStep(void* c) {
    std::string resp;
    if (!roundtrip(c, "{\"cmd\":\"step\"}", &resp) || !json_true(resp, "ok"))
        return -1;
    double it;
    return json_number(resp, "iteration", &it) ? static_cast<int>(it) : -1;
}

// blocks until the background loop reaches iteration n (1 = first results)
int PlaneverbWaitIteration(void* c, int n, float timeout_s) {
    std::string resp;
    std::string req = std::string("{\"cmd\":\"wait_iteration\",\"n\":") +
        fmt(n) + ",\"timeout\":" + fmt(timeout_s) + "}";
    if (!roundtrip(c, req, &resp)) return 0;
    return json_true(resp, "ok") ? 1 : 0;
}

// returns 1 and fills *out when the emission has valid params, else 0
// (occlusion -1 sentinel, zero-filled — PlaneverbUnity.cpp GetOutput +
// PlaneverbDSPUnity.cpp:102-110 NaN validation analog)
int PlaneverbGetOutput(void* c, int id, PlaneverbOutputC* out) {
    memset(out, 0, sizeof *out);
    out->occlusion = -1.0f;
    std::string resp;
    std::string req = std::string("{\"cmd\":\"get_output\",\"id\":") +
        fmt(id) + "}";
    if (!roundtrip(c, req, &resp) || !json_true(resp, "ok") ||
        !json_true(resp, "valid"))
        return 0;
    double occ, wet, rt, lp, dx, dy, sx, sy;
    if (!json_number(resp, "occlusion", &occ) ||
        !json_number(resp, "wet_gain", &wet) ||
        !json_number(resp, "rt60", &rt) ||
        !json_number(resp, "lowpass", &lp) ||
        !json_pair(resp, "direction", &dx, &dy) ||
        !json_pair(resp, "source_directivity", &sx, &sy))
        return 0;
    out->occlusion = static_cast<float>(occ);
    out->wetGain = static_cast<float>(wet);
    out->rt60 = static_cast<float>(rt);
    out->lowpass = static_cast<float>(lp);
    out->directionX = static_cast<float>(dx);
    out->directionY = static_cast<float>(dy);
    out->sourceDirectivityX = static_cast<float>(sx);
    out->sourceDirectivityY = static_cast<float>(sy);
    return 1;
}

// Multi-listener (split-screen) mode: B listeners at once, xyz packed as
// [x0,y0,z0, x1,y1,z1, ...]; per-view polls then pass a view index to
// PlaneverbGetOutputsEx. count=1 behaves like PlaneverbSetListenerPosition.
// Returns 1 on success, 0 on rejection (bad positions).
int PlaneverbSetListenerPositions(void* c, const float* xyz, int count) {
    if (count <= 0 || !xyz) return 0;
    std::string req = "{\"cmd\":\"set_listener_positions\",\"positions\":[";
    for (int i = 0; i < count; i++) {
        if (i) req += ",";
        req += std::string("[") + fmt(xyz[3 * i]) + "," +
               fmt(xyz[3 * i + 1]) + "," + fmt(xyz[3 * i + 2]) + "]";
    }
    req += "]}";
    std::string resp;
    return (roundtrip(c, req, &resp) && json_true(resp, "ok")) ? 1 : 0;
}

// Batched per-frame poll: every emitter's params in ONE round-trip. The
// reference's per-frame pattern polls each emitter through GetOutput
// (PlaneverbAudioSource.cs:171-183) — in-process that is free; over the
// socket each id costs a round-trip, so game loops should call this once
// per frame with all live ids. Fills outs[0..count); invalid emitters get
// the occlusion -1 sentinel, zero-filled. Returns the number of VALID
// outputs, or -1 on protocol failure. ``listener`` selects the view in
// multi-listener mode (0 otherwise).
int PlaneverbGetOutputsEx(void* c, const int* ids, int count, int listener,
                          PlaneverbOutputC* outs) {
    for (int i = 0; i < count; i++) {
        memset(&outs[i], 0, sizeof outs[i]);
        outs[i].occlusion = -1.0f;
    }
    if (count <= 0) return 0;
    std::string req = "{\"cmd\":\"get_outputs\",\"listener\":" +
        fmt(listener) + ",\"ids\":[";
    for (int i = 0; i < count; i++) {
        if (i) req += ",";
        req += fmt(ids[i]);
    }
    req += "]}";
    std::string resp;
    if (!roundtrip(c, req, &resp) || !json_true(resp, "ok")) return -1;
    // rows: 9 floats per id — occ, wet, rt60, lp, dir xy, srcdir xy, valid
    size_t pos;
    if (!find_key(resp, "rows", &pos)) return -1;
    while (pos < resp.size() && (resp[pos] == ' ' || resp[pos] == '['))
        pos++;
    int n_valid = 0;
    for (int i = 0; i < count; i++) {
        double v[9];
        for (int k = 0; k < 9; k++) {
            char* end = nullptr;
            v[k] = strtod(resp.c_str() + pos, &end);
            if (end == resp.c_str() + pos) return -1;
            pos = static_cast<size_t>(end - resp.c_str());
            while (pos < resp.size() &&
                   (resp[pos] == ',' || resp[pos] == ' '))
                pos++;
        }
        if (v[8] != 0.0) {
            outs[i].occlusion = static_cast<float>(v[0]);
            outs[i].wetGain = static_cast<float>(v[1]);
            outs[i].rt60 = static_cast<float>(v[2]);
            outs[i].lowpass = static_cast<float>(v[3]);
            outs[i].directionX = static_cast<float>(v[4]);
            outs[i].directionY = static_cast<float>(v[5]);
            outs[i].sourceDirectivityX = static_cast<float>(v[6]);
            outs[i].sourceDirectivityY = static_cast<float>(v[7]);
            n_valid++;
        }
    }
    return n_valid;
}

int PlaneverbGetOutputs(void* c, const int* ids, int count,
                        PlaneverbOutputC* outs) {
    return PlaneverbGetOutputsEx(c, ids, count, 0, outs);
}

}  // extern "C"

// JSON string escape for caller-supplied material names: quotes,
// backslashes and control characters would otherwise break the request
// line (or inject keys into it).
static std::string json_escape(const char* s) {
    std::string out;
    for (; s && *s; s++) {
        unsigned char ch = static_cast<unsigned char>(*s);
        switch (ch) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            default:
                if (ch < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", ch);
                    out += buf;
                } else {
                    out += static_cast<char>(ch);
                }
        }
    }
    return out;
}

extern "C" {

// AddGeometry with a material name resolved server-side against the
// 38-entry table (PlaneverbObject.cs:203-244 enum analog). ``material``
// must be a table name like "CONCRETE_ROUGH" (or a numeric string).
int PlaneverbAddGeometryMaterial(void* c, float x, float y, float width,
                                 float height, const char* material) {
    return reply_id(c, std::string("{\"cmd\":\"add_geometry\",\"x\":") +
                       fmt(x) + ",\"y\":" + fmt(y) + ",\"width\":" +
                       fmt(width) + ",\"height\":" + fmt(height) +
                       ",\"absorption\":\"" + json_escape(material) +
                       "\"}");
}

// UpdateGeometry preserving a named material (the float form above would
// require the caller to know the resolved R).
void PlaneverbUpdateGeometryMaterial(void* c, int id, float x, float y,
                                     float width, float height,
                                     const char* material) {
    fire(c, std::string("{\"cmd\":\"update_geometry\",\"id\":") + fmt(id) +
            ",\"x\":" + fmt(x) + ",\"y\":" + fmt(y) +
            ",\"width\":" + fmt(width) + ",\"height\":" + fmt(height) +
            ",\"absorption\":\"" + json_escape(material) + "\"}");
}

}  // extern "C"
