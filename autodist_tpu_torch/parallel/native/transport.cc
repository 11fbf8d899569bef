// Native framed-message data plane for the PS transport (the port's copy of
// autodist_tpu/parallel/native/transport.cc, with the same C ABI and two more
// entry points for the zero-copy hot path).
//
// One writev for header+payload, one malloc + full-read loop for receive,
// and (port additions) a scatter-gather send of many buffers under one frame
// header (tr_sendv) and a full read into a caller-owned buffer
// (tr_recv_into): the PS server's and client's every message, which carry
// borrowed tensor views out and land in a recycled receive buffer. Calls
// run with the GIL released (ctypes).
//
// Framing matches the Python path exactly: 8-byte big-endian length, then
// the payload, so native and Python endpoints interoperate freely.
//
// Build: g++ -O2 -shared -fPIC transport.cc -o transport.so  (done lazily by
// ps_transport.py through utils/native_build.py, like data/native/loader.cc).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <sys/socket.h>
#include <climits>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// Last failure's errno, per thread (0 = orderly EOF). The -1 return code
// collapses all failures; Python reads this back via tr_last_errno() so a
// native-path ConnectionError carries the same diagnostic the fallback's
// OSError would.
thread_local int g_last_errno = 0;

uint64_t to_be64(uint64_t v) {
  const uint16_t probe = 1;
  if (*reinterpret_cast<const uint8_t*>(&probe) == 0) return v;  // big-endian
  uint64_t r = 0;
  for (int i = 0; i < 8; ++i) r = (r << 8) | ((v >> (8 * i)) & 0xff);
  return r;
}

// Full-read loop; returns 0 on success, -1 on EOF/error, -2 when interrupted
// by a signal BEFORE any byte moved (so Python can run signal handlers at a
// clean message boundary and retry; mid-message interrupts retry here — the
// peer has committed to the message and it completes in bounded time).
int read_exact(int fd, void* buf, size_t n, bool* started) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r == 0) {                                // peer closed
      g_last_errno = 0;
      return -1;
    }
    if (r < 0) {
      if (errno == EINTR) {
        if (!*started) return -2;
        continue;
      }
      g_last_errno = errno;
      return -1;
    }
    *started = true;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return 0;
}

}  // namespace

extern "C" {

// Send one framed message (header + payload) with writev; loops until done.
// Returns 0 on success, -1 on error, -2 when a signal arrived before any byte
// was written (caller retries from Python so signal handlers run).
int tr_send(int fd, const void* buf, uint64_t n) {
  uint64_t hdr = to_be64(n);
  struct iovec iov[2];
  iov[0].iov_base = &hdr;
  iov[0].iov_len = sizeof(hdr);
  iov[1].iov_base = const_cast<void*>(buf);
  iov[1].iov_len = static_cast<size_t>(n);
  int idx = 0;
  bool started = false;
  while (idx < 2) {
    ssize_t w = ::writev(fd, &iov[idx], 2 - idx);
    if (w < 0) {
      if (errno == EINTR) {
        if (!started) return -2;
        continue;
      }
      g_last_errno = errno;
      return -1;
    }
    if (w > 0) started = true;
    auto remaining = static_cast<size_t>(w);
    while (idx < 2 && remaining >= iov[idx].iov_len) {
      remaining -= iov[idx].iov_len;
      ++idx;
    }
    if (idx < 2 && remaining > 0) {
      iov[idx].iov_base = static_cast<uint8_t*>(iov[idx].iov_base) + remaining;
      iov[idx].iov_len -= remaining;
    }
  }
  return 0;
}

// Receive one framed message. On success returns the payload length and sets
// *out to a malloc'd buffer (caller frees via tr_free). Returns -1 on
// EOF/error, -2 when a signal arrived before any byte of the message was read
// (caller retries from Python). No buffer is allocated on either error.
int64_t tr_recv(int fd, void** out) {
  uint64_t hdr;
  bool started = false;
  int rc = read_exact(fd, &hdr, sizeof(hdr), &started);
  if (rc != 0) return rc;
  uint64_t n = to_be64(hdr);
  void* buf = std::malloc(n ? static_cast<size_t>(n) : 1);
  if (buf == nullptr) {
    g_last_errno = ENOMEM;
    return -1;
  }
  if (n && read_exact(fd, buf, static_cast<size_t>(n), &started) != 0) {
    std::free(buf);
    return -1;
  }
  *out = buf;
  return static_cast<int64_t>(n);
}


// Send one framed message whose payload is the concatenation of n buffers:
// the header (their total length) and every buffer through writev, at most
// IOV_MAX iovecs a call, resuming mid-buffer after short writes. Returns 0
// on success, -1 on error, -2 when a signal arrived before any byte moved.
int tr_sendv(int fd, const void* const* bufs, const uint64_t* lens, int n) {
  uint64_t total = 0;
  for (int i = 0; i < n; ++i) total += lens[i];
  uint64_t hdr = to_be64(total);
  const int count = n + 1;
  struct iovec* iov = static_cast<struct iovec*>(std::malloc(sizeof(struct iovec) * count));
  if (iov == nullptr) {
    g_last_errno = ENOMEM;
    return -1;
  }
  iov[0].iov_base = &hdr;
  iov[0].iov_len = sizeof(hdr);
  for (int i = 0; i < n; ++i) {
    iov[i + 1].iov_base = const_cast<void*>(bufs[i]);
    iov[i + 1].iov_len = static_cast<size_t>(lens[i]);
  }
  int idx = 0;
  bool started = false;
  while (idx < count) {
    if (iov[idx].iov_len == 0) {
      ++idx;
      continue;
    }
    int batch = count - idx < IOV_MAX ? count - idx : IOV_MAX;
    ssize_t w = ::writev(fd, &iov[idx], batch);
    if (w < 0) {
      if (errno == EINTR) {
        if (!started) {
          std::free(iov);
          return -2;
        }
        continue;
      }
      g_last_errno = errno;
      std::free(iov);
      return -1;
    }
    if (w > 0) started = true;
    auto remaining = static_cast<size_t>(w);
    while (idx < count && remaining >= iov[idx].iov_len) {
      remaining -= iov[idx].iov_len;
      ++idx;
    }
    if (idx < count && remaining > 0) {
      iov[idx].iov_base = static_cast<uint8_t*>(iov[idx].iov_base) + remaining;
      iov[idx].iov_len -= remaining;
    }
  }
  std::free(iov);
  return 0;
}

// Read exactly n bytes into buf. Returns 0 on success, -1 on EOF/error, -2
// when a signal arrived before any byte was read (the caller retries).
int tr_recv_into(int fd, void* buf, uint64_t n) {
  bool started = false;
  return read_exact(fd, buf, static_cast<size_t>(n), &started);
}

void tr_free(void* p) { std::free(p); }

// errno of this thread's most recent tr_send/tr_recv failure (0 = the peer
// closed the connection in an orderly way). Valid immediately after a -1.
int tr_last_errno() { return g_last_errno; }

}  // extern "C"
