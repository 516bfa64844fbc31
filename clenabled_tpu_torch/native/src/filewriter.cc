// Async rolling file writer with JSON sidecar metadata.
//
// Mirrors clXEngine's direct-to-disk output: size-based file rollover and a
// JSON metadata sidecar per output file
// (lib/clXEngine_impl.cc:438-465, :1259-1277 of gr-clenabled), but writes
// happen on a dedicated worker thread so the streaming loop never blocks on
// disk (the reference fwrites inline on its correlator worker).

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FileWriter {
  std::string base;
  std::string sidecar_json;
  size_t rollover_bytes;
  size_t written_in_file = 0;
  int file_index = 0;
  FILE* fp = nullptr;

  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> queue;
  std::atomic<bool> stop{false};
  std::thread worker;

  void open_next() {
    if (fp) fclose(fp);
    char name[4096];
    snprintf(name, sizeof(name), "%s_%d.bin", base.c_str(), file_index);
    fp = fopen(name, "wb");
    if (!sidecar_json.empty() && fp) {
      char meta[4096];
      snprintf(meta, sizeof(meta), "%s_%d.json", base.c_str(), file_index);
      if (FILE* mf = fopen(meta, "w")) {
        fputs(sidecar_json.c_str(), mf);
        fclose(mf);
      }
    }
    file_index++;
    written_in_file = 0;
  }

  void run() {
    for (;;) {
      std::vector<uint8_t> chunk;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stop.load()) break;
          continue;
        }
        chunk = std::move(queue.front());
        queue.pop_front();
      }
      if (!fp || (rollover_bytes && written_in_file + chunk.size() > rollover_bytes)) {
        open_next();
      }
      if (fp) {
        fwrite(chunk.data(), 1, chunk.size(), fp);
        written_in_file += chunk.size();
      }
    }
    if (fp) {
      fclose(fp);
      fp = nullptr;
    }
  }
};

}  // namespace

extern "C" {

void* fw_create(const char* base, size_t rollover_bytes, const char* sidecar) {
  auto* w = new FileWriter();
  w->base = base;
  w->rollover_bytes = rollover_bytes;
  w->sidecar_json = sidecar ? sidecar : "";
  w->worker = std::thread([w] { w->run(); });
  return w;
}

void fw_write(void* h, const void* data, size_t n) {
  auto* w = static_cast<FileWriter*>(h);
  std::vector<uint8_t> chunk(n);
  std::memcpy(chunk.data(), data, n);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(chunk));
  }
  w->cv.notify_one();
}

size_t fw_queue_depth(void* h) {
  auto* w = static_cast<FileWriter*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  return w->queue.size();
}

int fw_file_count(void* h) { return static_cast<FileWriter*>(h)->file_index; }

void fw_close(void* h) {
  auto* w = static_cast<FileWriter*>(h);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stop.store(true);
  }
  w->cv.notify_one();
  if (w->worker.joinable()) w->worker.join();
  delete w;
}

}  // extern "C"
