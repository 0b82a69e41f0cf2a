// A C host of the port's C ABI: init with whisper_context_params whose
// use_gpu follows argv[3] ("cpu": false, "cuda": true), whisper_full with
// the struct params at their greedy defaults (language "en", no temperature
// fallback), then every segment with its tokens.  With "cuda" and no card,
// init returns NULL and the host exits 1: nothing carries on on the CPU.
//
// usage: abi_host <model.bin> <pcm.f32> cpu|cuda
// build: whisper_tpu_torch/abi.py build_host (gcc -I native ...
//        -lwhisper_tpu_torch)

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "whisper_tpu.h"

int main(int argc, char ** argv) {
    if (argc != 4 || (strcmp(argv[3], "cpu") != 0 && strcmp(argv[3], "cuda") != 0)) {
        fprintf(stderr, "usage: %s model.bin pcm.f32 cpu|cuda\n", argv[0]);
        return 2;
    }
    FILE * f = fopen(argv[2], "rb");
    if (!f) { fprintf(stderr, "no pcm\n"); return 2; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    float * pcm = (float *) malloc(sz > 0 ? (size_t) sz : 1);
    if (fread(pcm, 1, (size_t) sz, f) != (size_t) sz) { fprintf(stderr, "short pcm\n"); return 2; }
    fclose(f);

    struct whisper_context_params cp = whisper_context_default_params();
    cp.use_gpu = strcmp(argv[3], "cuda") == 0;
    struct whisper_context * ctx = whisper_init_from_file_with_params(argv[1], cp);
    if (!ctx) { fprintf(stderr, "init failed (use_gpu=%d)\n", (int) cp.use_gpu); return 1; }

    struct whisper_full_params p = whisper_full_default_params(WHISPER_SAMPLING_GREEDY);
    p.language = "en";
    p.temperature_inc = 0.0f;
    p.print_progress = false;
    int rc = whisper_full(ctx, p, pcm, (int) (sz / 4));
    if (rc != 0) { fprintf(stderr, "whisper_full rc=%d\n", rc); return 1; }

    int n = whisper_full_n_segments(ctx);
    printf("n_segments=%d\n", n);
    for (int i = 0; i < n; ++i) {
        printf("[%lld -> %lld] %s |", (long long) whisper_full_get_segment_t0(ctx, i),
               (long long) whisper_full_get_segment_t1(ctx, i),
               whisper_full_get_segment_text(ctx, i));
        for (int j = 0; j < whisper_full_n_tokens(ctx, i); ++j) {
            printf(" %d", whisper_full_get_token_id(ctx, i, j));
        }
        printf("\n");
    }
    whisper_free(ctx);
    free(pcm);
    printf("ABI-HOST-OK\n");
    return 0;
}
