/* LD_PRELOAD allocator shim: every allocation is zero-born.
 *
 * The reference's model classes read uninitialized allocator memory (the
 * hand-rolled ConvTranspose1d never memsets the gaps of its zero-stuffed
 * intermediate, <reference>/src/hifigan.cpp:50-55, and ggml's CPU
 * backend reallocs its graph work buffer per compute) — they are only
 * correct when every allocation happens to arrive as fresh zero mmap
 * pages, which a fresh process mostly grants and a long-lived or
 * heap-churned one does not.  mallopt(M_MMAP_THRESHOLD) is NOT enough:
 * it only gates brk-vs-mmap for NEW memory, while requests served from
 * an existing free-list chunk return dirty bytes regardless.
 *
 * Preloading this shim into the dedicated stage-worker process
 * (zerovox_tpu_torch/refharness/stage_proc.py) makes the fresh-pages assumption
 * literally true for every allocation, deterministically, without
 * modifying the reference sources.  Only the worker pays the memset cost.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <malloc.h>
#include <string.h>

extern void *__libc_malloc(size_t n);
extern void *__libc_realloc(void *p, size_t n);
extern void *__libc_memalign(size_t align, size_t n);

/* Zero the chunk's FULL usable size, not just the request: realloc
 * growth that stays within the old chunk's slack skips its memset (the
 * n > old test below uses usable size), so bytes in [request, usable)
 * must already be zero-born or they leak through that path dirty. */
void *malloc(size_t n)
{
    void *p = __libc_malloc(n);
    if (p)
        memset(p, 0, malloc_usable_size(p));
    return p;
}

void *realloc(void *q, size_t n)
{
    size_t old = q ? malloc_usable_size(q) : 0;
    void *p = __libc_realloc(q, n);
    if (p && malloc_usable_size(p) > old)
        memset((char *) p + old, 0, malloc_usable_size(p) - old);
    return p;
}

void *memalign(size_t align, size_t n)
{
    void *p = __libc_memalign(align, n);
    if (p)
        memset(p, 0, malloc_usable_size(p));
    return p;
}

void *aligned_alloc(size_t align, size_t n)
{
    return memalign(align, n);
}

int posix_memalign(void **res, size_t align, size_t n)
{
    void *p = __libc_memalign(align, n);
    if (!p)
        return ENOMEM;
    memset(p, 0, malloc_usable_size(p));
    *res = p;
    return 0;
}

/* calloc and free fall through to libc (calloc already zeroes). */
