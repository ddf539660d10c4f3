"""Row sharding of the frame over a mesh of devices: the port of the JAX
package's ``parallel/`` (``sharding``, ``halo``). Its ``context``, the
mesh under which the Pallas wrappers shard themselves, is not ported:
the split frame is the one route.

The split frame (``EffectComposer._build_frame_fn(mesh)``) places each
stage of the frame so (H the frame's height; a "whole" stage gathers its
inputs on the composer's device, runs there and splits its outputs):

====================================  ==========================  =====================
stage (port module)                   placement                   vertical reach
====================================  ==========================  =====================
raster: z-scan, alpha variant,        whole, on the composer's    whole frame
record fetch (``scene/rasterizer``,   device; G-buffer and
``ops/raster_kernel``,                velocity then split
``ops/table_kernel``)
shade (``scene/shading``)             per shard                   0 rows; uv from the
                                                                  global row
SSGI trace: sweep                     sources gathered once a     whole frame
(``ops/ssgi_sweep``,                  frame (``replicate_for_
``ops/sweep_kernel``) and march       rolls``): the sweep whole
(``ops/ssgi``)                        on the composer's device
                                      from per-shard planes; the
                                      march per shard from the
                                      gathered depth, velocity
                                      and composed output
SSGI glue before and after the trace  per shard, halo-extended    radiance prewarp
                                                                  ``ky + 1`` (9);
                                                                  ``env_fetch_stride
                                                                  - 1`` after it
temporal reproject                    per shard, halo-extended    ``window_ky`` (8) + 2
(``ops/temporal_reproject``)                                      (catrom) + 2 (minmax)
                                                                  + 1 (``fwidth``)
Poisson denoise                       per shard, halo again each  as
(``ops/poisson_denoise``)             pass                        ``poisson_denoise_
                                                                  sharded``
denoiser compose, SSGI compose        per shard                   0 rows
(``ops/denoiser_compose``,
``ops/compose``)
HBAO, AO Poisson, AO compose          per shard, halo-extended    ``window_ky`` (32);
(``effects/ao``,                                                  the Poisson passes'
``ops/hbao_kernel``)                                              own
motion blur (``ops/motion_blur``)     source gathered once; each  up to 0.25 x diagonal
                                      shard computes its rows
TRAA (``effects/traa``)               per shard, halo-extended    as temporal reproject
every other effect (SSR, GTAO, TAA,   whole, declared             --
FXAA, SMAA, the finishing and
post-FX stack), and SSGI / AO at
``resolution_scale < 1``, HBAO off
the fused kernel, a raster with
``msaa > 1`` (shade whole)
====================================  ==========================  =====================

The frame reports each stage's placement (``composer.last_placement``).
A stage that raises on a shard raises out of the frame; only the
declared "whole" stages run whole.
"""
