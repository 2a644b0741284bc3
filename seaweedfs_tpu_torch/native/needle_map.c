/* Compact needle map — native per-volume key index.
 *
 * Role of the reference's CompactMap (weed/storage/needle_map/
 * compact_map.go:14-40,176-246): hold needleId -> (offset,size) for tens
 * of millions of needles per volume at ~16 bytes/entry (its perf test
 * budgets 100M entries — a Python dict at ~100+B/entry cannot).
 *
 * Design: open-addressing hash table with linear probing and 16-byte
 * entries (key 8B, offset 4B, size 4B), power-of-two capacity, grown at
 * 70% load. The reference exploits mostly-ascending keys with sorted
 * sections + binary search; a flat power-of-two table gets the same
 * memory footprint with O(1) worst-ish lookups and no sortedness
 * assumption, which suits batch-oriented loaders better.
 *
 * key 0 is reserved as the empty marker (SeaweedFS needle ids start at 1;
 * the Python wrapper keeps a sideband slot for key 0 just in case).
 * Deletes store the tombstone size value directly — identical semantics
 * to the .idx replay (TombstoneFileSize = 0xFFFFFFFF).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
    uint64_t key;
    uint32_t offset;
    uint32_t size;
} nm_entry;

typedef struct {
    nm_entry *slots;
    uint64_t cap;     /* power of two */
    uint64_t used;    /* occupied slots (incl. tombstone-size entries) */
} nm_map;

static uint64_t nm_hash(uint64_t k) {
    /* splitmix64 finalizer: good avalanche for sequential ids */
    k ^= k >> 30; k *= 0xbf58476d1ce4e5b9ULL;
    k ^= k >> 27; k *= 0x94d049bb133111ebULL;
    k ^= k >> 31;
    return k;
}

void *swtpu_nm_new(void) {
    nm_map *m = (nm_map *)calloc(1, sizeof(nm_map));
    if (!m) return 0;
    m->cap = 1024;
    m->slots = (nm_entry *)calloc(m->cap, sizeof(nm_entry));
    if (!m->slots) { free(m); return 0; }
    return m;
}

void swtpu_nm_free(void *h) {
    nm_map *m = (nm_map *)h;
    if (!m) return;
    free(m->slots);
    free(m);
}

static nm_entry *nm_slot(nm_map *m, uint64_t key) {
    uint64_t mask = m->cap - 1;
    uint64_t i = nm_hash(key) & mask;
    while (m->slots[i].key != 0 && m->slots[i].key != key)
        i = (i + 1) & mask;
    return &m->slots[i];
}

static int nm_grow(nm_map *m) {
    uint64_t old_cap = m->cap;
    nm_entry *old = m->slots;
    nm_entry *fresh = (nm_entry *)calloc(old_cap * 2, sizeof(nm_entry));
    if (!fresh) return 0;
    m->slots = fresh;
    m->cap = old_cap * 2;
    for (uint64_t i = 0; i < old_cap; i++) {
        if (old[i].key != 0)
            *nm_slot(m, old[i].key) = old[i];
    }
    free(old);
    return 1;
}

/* returns: -1 alloc failure, 0 inserted new, 1 replaced existing;
 * old_offset/old_size receive the previous value when replacing */
int swtpu_nm_set(void *h, uint64_t key, uint32_t offset, uint32_t size,
                 uint32_t *old_offset, uint32_t *old_size) {
    nm_map *m = (nm_map *)h;
    if (key == 0) return -1;
    if ((m->used + 1) * 10 >= m->cap * 7) {
        if (!nm_grow(m)) return -1;
    }
    nm_entry *e = nm_slot(m, key);
    if (e->key == key) {
        if (old_offset) *old_offset = e->offset;
        if (old_size) *old_size = e->size;
        e->offset = offset;
        e->size = size;
        return 1;
    }
    e->key = key;
    e->offset = offset;
    e->size = size;
    m->used++;
    return 0;
}

int swtpu_nm_get(void *h, uint64_t key, uint32_t *offset, uint32_t *size) {
    nm_map *m = (nm_map *)h;
    if (key == 0) return 0;
    nm_entry *e = nm_slot(m, key);
    if (e->key != key) return 0;
    if (offset) *offset = e->offset;
    if (size) *size = e->size;
    return 1;
}

uint64_t swtpu_nm_len(void *h) {
    return ((nm_map *)h)->used;
}

/* copy up to max entries starting at cursor position *state into the out
 * arrays; returns number copied and advances *state (0 = start). */
uint64_t swtpu_nm_scan(void *h, uint64_t *state, uint64_t *keys,
                       uint32_t *offsets, uint32_t *sizes, uint64_t max) {
    nm_map *m = (nm_map *)h;
    uint64_t n = 0, i = *state;
    for (; i < m->cap && n < max; i++) {
        if (m->slots[i].key != 0) {
            keys[n] = m->slots[i].key;
            offsets[n] = m->slots[i].offset;
            sizes[n] = m->slots[i].size;
            n++;
        }
    }
    *state = i;
    return n;
}

#ifdef __cplusplus
}
#endif
