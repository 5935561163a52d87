// Sanitizer smoke program — `make -C iotml_torch/cpp sanitize`.
//
// The port's copy of the JAX package's smoke program, over its engines:
// the message-set codec lives in msgset_engine.cc here (not in
// kafka_client.cc), and its encode takes a val_null column.
//
// The .so is loaded into ONE process and called from MANY Python threads
// concurrently: every wire-server handler thread runs the MessageSet
// codec (iotml_msgset_encode/decode), and ingest bridges poll their
// handles while other threads query them.  This program reproduces that
// threading shape natively so TSan/ASan can see it without the Python
// interpreter in the way:
//
//   * T concurrent threads × R rounds of columnar encode → decode →
//     verify round-trips, all through the shared global state the codec
//     owns (crc table, allocator); every 5th value is null (a
//     tombstone), so the val_null path runs too
//   * an MQTT ingest handle created/queried/closed across threads
//
// Exit 0 with "sanitize smoke: OK" when clean; TSan/ASan abort with a
// report otherwise.  Build targets: `make tsan`, `make asan` (libraries)
// and `make sanitize` (this program under both sanitizers).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int64_t iotml_msgset_encode(const uint8_t* values, const int64_t* val_off,
                            const uint8_t* val_null, const uint8_t* keys,
                            const int64_t* key_off, const uint8_t* key_null,
                            const int64_t* timestamps,
                            const int64_t* offsets, int64_t n,
                            uint8_t* out_buf, int64_t out_cap);
int64_t iotml_msgset_decode(const uint8_t* buf, int64_t len, int64_t max_n,
                            int64_t* offsets, int64_t* ts,
                            int64_t* key_off, uint8_t* key_null,
                            uint8_t* keys, int64_t keys_cap,
                            int64_t* val_off, uint8_t* val_null,
                            uint8_t* values, int64_t values_cap);
void* iotml_mqtt_ingest_create(uint16_t port);
int iotml_mqtt_ingest_port(void* h);
long iotml_mqtt_ingest_conns(void* h);
void iotml_mqtt_ingest_close(void* h);
}

namespace {

std::atomic<long> g_failures{0};

void codec_worker(int seed, int rounds) {
  const int64_t n = 64;
  for (int r = 0; r < rounds; ++r) {
    // columnar batch: values "v<seed>-<r>-<i>", every 3rd key null and
    // every 5th value null
    std::string values, keys;
    std::vector<int64_t> voff(n + 1, 0), koff(n + 1, 0), ts(n), offs(n);
    std::vector<uint8_t> knull(n), vnull(n);
    for (int64_t i = 0; i < n; ++i) {
      char buf[64];
      vnull[i] = i % 5 == 4;
      if (!vnull[i]) {
        snprintf(buf, sizeof buf, "v%d-%d-%lld", seed, r,
                 static_cast<long long>(i));
        values += buf;
      }
      voff[i + 1] = static_cast<int64_t>(values.size());
      knull[i] = i % 3 == 0;
      if (!knull[i]) {
        snprintf(buf, sizeof buf, "k%lld", static_cast<long long>(i));
        keys += buf;
      }
      koff[i + 1] = static_cast<int64_t>(keys.size());
      ts[i] = 1700000000000LL + i;
      offs[i] = seed * 100000 + r * 1000 + i;
    }
    std::vector<uint8_t> wire(values.size() + keys.size() + 64 * n);
    int64_t wlen = iotml_msgset_encode(
        reinterpret_cast<const uint8_t*>(values.data()), voff.data(),
        vnull.data(), reinterpret_cast<const uint8_t*>(keys.data()),
        koff.data(),
        knull.data(), ts.data(), offs.data(), n, wire.data(),
        static_cast<int64_t>(wire.size()));
    if (wlen <= 0) { g_failures++; return; }

    std::vector<int64_t> d_off(n), d_ts(n), d_koff(n + 1), d_voff(n + 1);
    std::vector<uint8_t> d_knull(n), d_vnull(n);
    std::vector<uint8_t> d_keys(keys.size() + 1), d_values(values.size() + 1);
    int64_t got = iotml_msgset_decode(
        wire.data(), wlen, n, d_off.data(), d_ts.data(), d_koff.data(),
        d_knull.data(), d_keys.data(),
        static_cast<int64_t>(d_keys.size()), d_voff.data(), d_vnull.data(),
        d_values.data(), static_cast<int64_t>(d_values.size()));
    if (got != n || d_off[0] != offs[0] || d_ts[n - 1] != ts[n - 1] ||
        d_voff[n] != voff[n] || d_vnull[4] != 1 || d_vnull[0] != 0 ||
        memcmp(d_values.data(), values.data(), values.size()) != 0) {
      g_failures++;
      return;
    }
  }
}

}  // namespace

int main() {
  const int kThreads = 8, kRounds = 200;
  std::vector<std::thread> pool;
  pool.reserve(kThreads + 1);
  for (int t = 0; t < kThreads; ++t)
    pool.emplace_back(codec_worker, t, kRounds);

  // ingest handle shared across threads (create here, query from a
  // second thread, close after join) — the bridge's lifecycle shape
  void* ingest = iotml_mqtt_ingest_create(0);
  if (ingest != nullptr) {
    pool.emplace_back([ingest] {
      for (int i = 0; i < 100; ++i) {
        if (iotml_mqtt_ingest_port(ingest) <= 0) g_failures++;
        if (iotml_mqtt_ingest_conns(ingest) != 0) g_failures++;
      }
    });
  } else {
    g_failures++;
  }

  for (auto& th : pool) th.join();
  if (ingest != nullptr) iotml_mqtt_ingest_close(ingest);

  if (g_failures.load() != 0) {
    fprintf(stderr, "sanitize smoke: %ld failure(s)\n", g_failures.load());
    return 1;
  }
  printf("sanitize smoke: OK\n");
  return 0;
}
