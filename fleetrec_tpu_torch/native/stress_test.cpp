// TSAN/stress driver for the ingest ring: 3 senders x many batches over
// localhost, small slots, consumer validating per-sender fill patterns.
// Build: make stress && ./stress_test   (or make stress_tsan)
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
void* ing_create(int, const long*, int, int);
void* ing_create_mc(int, const long*, int, int, int, long);
int ing_listen(void*);
void ing_start(void*);
int ing_acquire(void*, int);
float* ing_slot_data(void*, int);
void ing_release(void*, int);
long ing_total_batches(void*);
void ing_destroy(void*);
long loadgen_run(const char*, int, long, long, float);
long loadgen_run_striped(const char*, int, int, long, long, long, float, int);
void* scat_create(int);
int scat_connect(void*, const char*, int);
int scat_send(void*, const void*, long);
long scat_sent_blocks(void*, int);
long scat_skipped(void*);
void scat_destroy(void*);
}

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

// Scatter fan-out phase: 3 in-process listening consumers (one slow),
// producer round-robins 200 blocks; validates delivery count + that the
// slow consumer shed load without stalling the producer.
static int stress_scatter() {
  const int NCONS = 3, PORT = 19400, BLOCK = 4096;
  const long NBLK = 200;
  std::vector<std::thread> cons;
  std::vector<long> recv_blocks(NCONS, 0);
  for (int c = 0; c < NCONS; ++c) {
    cons.emplace_back([c, &recv_blocks] {
      int srv = ::socket(AF_INET, SOCK_STREAM, 0);
      int one = 1;
      setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
      sockaddr_in a{};
      a.sin_family = AF_INET;
      a.sin_addr.s_addr = INADDR_ANY;
      a.sin_port = htons((uint16_t)(PORT + c));
      if (bind(srv, (sockaddr*)&a, sizeof(a)) < 0 || listen(srv, 1) < 0) {
        fprintf(stderr, "scatter consumer %d bind failed\n", c);
        return;
      }
      int fd = ::accept(srv, nullptr, nullptr);
      std::vector<char> buf(BLOCK);
      while (true) {
        size_t got = 0;
        while (got < (size_t)BLOCK) {
          ssize_t r = ::recv(fd, buf.data() + got, BLOCK - got, 0);
          if (r <= 0) goto done;
          got += (size_t)r;
        }
        ++recv_blocks[c];
        if (c == 0) usleep(5000);  // slow consumer
      }
    done:
      ::close(fd);
      ::close(srv);
    });
  }
  usleep(100 * 1000);
  void* sc = scat_create(2);
  for (int c = 0; c < NCONS; ++c) {
    if (scat_connect(sc, "127.0.0.1", PORT + c) < 0) {
      fprintf(stderr, "scatter connect %d failed\n", c);
      return 1;
    }
  }
  std::vector<char> block(BLOCK, 7);
  for (long b = 0; b < NBLK; ++b) {
    if (scat_send(sc, block.data(), BLOCK) < 0) {
      fprintf(stderr, "scat_send failed at %ld\n", b);
      return 1;
    }
  }
  long skipped = scat_skipped(sc);
  scat_destroy(sc);  // drains queues, then closes -> consumers EOF out
  for (auto& t : cons) t.join();
  long recvd = recv_blocks[0] + recv_blocks[1] + recv_blocks[2];
  if (recvd != NBLK) {
    fprintf(stderr, "scatter lost blocks: %ld/%ld\n", recvd, NBLK);
    return 1;
  }
  printf("scatter stress OK: %ld blocks (slow got %ld, skips %ld)\n", recvd,
         recv_blocks[0], skipped);
  return 0;
}

// Striped multi-connection phase: 2 senders x 4 conns, ramp-coded payloads
// so any stripe-reassembly offset error shows as a value mismatch. Sender 1
// has a non-multiple payload (tail packet short) and sender 0 has fewer
// packets than conns (active clamp).
static int stress_striped() {
  const int SENDERS = 2, SLOTS = 2, PORT = 19200, CONNS = 4;
  const long NB = 300, PKG = 256;
  long bytes[SENDERS] = {512 /* 2 pkgs < 4 conns */, 2304 /* 9 pkgs */};
  void* h = ing_create_mc(SENDERS, bytes, SLOTS, PORT, CONNS, PKG);
  if (ing_listen(h) != 0) {
    fprintf(stderr, "striped listen failed\n");
    return 1;
  }
  ing_start(h);
  std::vector<std::thread> senders;
  for (int s = 0; s < SENDERS; ++s) {
    senders.emplace_back([=] {
      long r = loadgen_run_striped("127.0.0.1", PORT + s * CONNS, CONNS, PKG,
                                   bytes[s], NB, 0.0f, /*ramp=*/1);
      if (r != NB) fprintf(stderr, "striped sender %d failed: %ld\n", s, r);
    });
  }
  for (long b = 0; b < NB; ++b) {
    int slot = ing_acquire(h, 10000);
    if (slot < 0) {
      fprintf(stderr, "striped acquire failed at %ld: %d\n", b, slot);
      return 1;
    }
    float* d = ing_slot_data(h, slot);
    long off = 0;
    for (int s = 0; s < SENDERS; ++s) {
      for (long i = 0; i < bytes[s] / 4; ++i) {
        if (d[off + i] != (float)i) {
          fprintf(stderr, "striped batch %ld sender %d corrupt at %ld: %f\n",
                  b, s, i, d[off + i]);
          return 1;
        }
      }
      off += bytes[s] / 4;
    }
    ing_release(h, slot);
  }
  for (auto& t : senders) t.join();
  long tb = ing_total_batches(h);
  ing_destroy(h);
  printf("striped stress OK: %ld batches\n", tb);
  return 0;
}

int main() {
  const int SENDERS = 3, SLOTS = 2, PORT = 19080;
  const long NB = 500;
  long bytes[SENDERS] = {256, 1024, 512};
  void* h = ing_create(SENDERS, bytes, SLOTS, PORT);
  if (ing_listen(h) != 0) {
    fprintf(stderr, "listen failed\n");
    return 1;
  }
  ing_start(h);
  std::vector<std::thread> senders;
  for (int s = 0; s < SENDERS; ++s) {
    senders.emplace_back([=] {
      long r = loadgen_run("127.0.0.1", PORT + s, bytes[s], NB, (float)(s + 1));
      if (r != NB) fprintf(stderr, "sender %d failed: %ld\n", s, r);
    });
  }
  for (long b = 0; b < NB; ++b) {
    int slot = ing_acquire(h, 10000);
    if (slot < 0) {
      fprintf(stderr, "acquire failed at %ld: %d\n", b, slot);
      return 1;
    }
    float* d = ing_slot_data(h, slot);
    long off = 0;
    for (int s = 0; s < SENDERS; ++s) {
      for (long i = 0; i < bytes[s] / 4; ++i) {
        if (d[off + i] != (float)(s + 1)) {
          fprintf(stderr, "batch %ld sender %d corrupt at %ld: %f\n", b, s, i,
                  d[off + i]);
          return 1;
        }
      }
      off += bytes[s] / 4;
    }
    ing_release(h, slot);
  }
  for (auto& t : senders) t.join();
  long tb = ing_total_batches(h);
  ing_destroy(h);
  printf("stress OK: %ld batches\n", tb);
  if (int rc = stress_striped()) return rc;
  return stress_scatter();
}
