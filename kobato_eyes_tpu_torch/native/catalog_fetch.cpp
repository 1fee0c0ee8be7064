// Native catalog reader: file_tags -> packed columnar buffers.
//
// The epoch build's dominant cost at 300k files / 8.8M postings was
// sqlite3's Python binding creating one tuple per row (~32 s measured for
// fetchall alone).  This reader walks the same statement through the
// sqlite3 C API on a separate READ-ONLY connection and writes straight into
// caller-provided int64/int64/double buffers (numpy arrays) — no Python
// objects on the hot path.  Python-side parity with the fetchall path is
// enforced by tests/query/test_native_fetch.py.
//
// The sqlite3 C ABI is stable; the image ships libsqlite3.so.0 without dev
// headers, so the handful of entry points used are declared here directly
// (same technique the image's own Python links against).

extern "C" {

typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;

int sqlite3_open_v2(const char *filename, sqlite3 **db, int flags, const char *vfs);
int sqlite3_prepare_v2(sqlite3 *db, const char *sql, int nbyte, sqlite3_stmt **stmt,
                       const char **tail);
int sqlite3_step(sqlite3_stmt *stmt);
long long sqlite3_column_int64(sqlite3_stmt *stmt, int col);
double sqlite3_column_double(sqlite3_stmt *stmt, int col);
int sqlite3_finalize(sqlite3_stmt *stmt);
int sqlite3_close(sqlite3 *db);
int sqlite3_busy_timeout(sqlite3 *db, int ms);

}  // extern "C"

namespace {
constexpr int kOpenReadonly = 0x00000001;
constexpr int kRow = 100;
constexpr int kDone = 101;
constexpr int kOk = 0;
}  // namespace

extern "C" {

// Returns the number of rows written (<= cap), or a negative error code:
//   -1 open failed, -2 prepare failed, -3 step error, -4 cap exceeded.
// On -4 the first `cap` rows are valid; the caller should fall back.
long long ket_fetch_file_tags(const char *db_path, long long cap,
                              long long *file_ids, long long *tag_ids,
                              double *scores) {
  sqlite3 *db = nullptr;
  if (sqlite3_open_v2(db_path, &db, kOpenReadonly, nullptr) != kOk) {
    if (db) sqlite3_close(db);
    return -1;
  }
  sqlite3_busy_timeout(db, 30000);
  sqlite3_stmt *stmt = nullptr;
  static const char kSql[] = "SELECT file_id, tag_id, score FROM file_tags";
  if (sqlite3_prepare_v2(db, kSql, -1, &stmt, nullptr) != kOk) {
    sqlite3_close(db);
    return -2;
  }
  long long n = 0;
  int rc;
  while ((rc = sqlite3_step(stmt)) == kRow) {
    if (n >= cap) {
      sqlite3_finalize(stmt);
      sqlite3_close(db);
      return -4;
    }
    file_ids[n] = sqlite3_column_int64(stmt, 0);
    tag_ids[n] = sqlite3_column_int64(stmt, 1);
    scores[n] = sqlite3_column_double(stmt, 2);
    ++n;
  }
  sqlite3_finalize(stmt);
  sqlite3_close(db);
  return rc == kDone ? n : -3;
}

}  // extern "C"
