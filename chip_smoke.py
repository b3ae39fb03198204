#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases build,kernels  # a kernel-only check
    python3 chip_smoke.py --phases build,kernels,train  # the training path
    python3 chip_smoke.py --phases build,kernels,forward,serve,int8  # int8
    python3 chip_smoke.py --phases build,kernels,ring,rtc  # ring and rtc
    python3 chip_smoke.py --phases device,build,ndarray  # the frontend
    python3 chip_smoke.py --phases device,build,bert  # Gluon and BERT
    python3 chip_smoke.py --phases device,build,resnet  # ResNet-50 training
    python3 chip_smoke.py --phases device,build,kernels,bert,resnet
                                                  # compiled training
    python3 chip_smoke.py --phases device,build,kernels,bf16  # bf16
    python3 chip_smoke.py --phases device,build,qresnet  # int8 ResNet-50
    python3 chip_smoke.py --phases device,build,optim  # the optimizers
    python3 chip_smoke.py --phases device,build,dist,ring  # data parallel
    python3 chip_smoke.py --phases device,build,dist_async  # the parameter
                                                  # server
    python3 chip_smoke.py --phases device,build,sharding  # mx.sharding
    python3 chip_smoke.py --phases device,build,elastic,pipeline,moe
                                                  # elastic training,
                                                  # pipelines and MoE
    python3 chip_smoke.py --phases device,build,sparse  # row-sparse
                                                  # training, A3 ops
    python3 chip_smoke.py --phases device,build,symbol  # export, import,
                                                  # amp.convert_model, bulking
    python3 chip_smoke.py --phases device,build,gluon  # the HF import of
                                                  # the Gluon Llama
    python3 chip_smoke.py --host-cost build/parent  # mx.np.add's host
                                                  # cost against another
                                                  # checkout's, in turns
    python3 chip_smoke.py --llama-host-cost build/parent  # the Llama's
                                                  # eager calls' host ms
                                                  # against another
                                                  # checkout's, in turns

Phases, each of which fails the run on any error:

1. device   -- a CUDA card must be there; print ``nvidia-smi``'s name and
               power limit.
2. build    -- compile ``mxnet_tpu_torch/csrc/*.cu`` (one ``nvcc`` each, in
               parallel) into ``build/kernels/``.
3. kernels  -- hold each hand-written kernel against its plain PyTorch
               version on the card at ``llama3_8b`` shapes (fp32; the int8
               product with fp32 or bf16 out, bit-equal), and time the
               kernel, the plain version and, where one PyTorch call
               computes the same function, that call. The int8 product
               and flash attention name the design their plan took; the
               int8 product's earlier design (sm80) is timed beside it,
               and the int8 wrapper's host cost per call is logged. Paged
               decode names its split count, is timed at half and twice
               that count too, and is replayed from a CUDA graph after its
               offsets and block table were rewritten in place. The
               gradients of the norm and flash ops (their
               ``autograd.Function``s) meet autograd through the plain
               versions. The norm names its design (``regs``, the row
               in registers, or ``cluster``, a short batch's rows split
               over thread-block clusters) and times the earlier one
               (``general``) beside it, RMS and LayerNorm at (4 / 32 /
               512 / 2048, 4096) and LayerNorm at BERT-base's (512,
               768) and (4096, 768) with eps 1e-12 (a (32, 128) batch);
               flash attention at BERT-base's BH 384, T = S = 128 and BH
               96, T = S = 512, d 64, full; at (4, 4096) and (32, 4096)
               its designs are timed
               in turns with the launch floor (an empty kernel) and the
               copy floor (the regs grid and block writing x * gamma, no
               reduction), both compiled through ``rtc``. Adam and
               SGD-momentum take their hyperparameters from a device
               vector; an SGD-momentum update captured in a CUDA graph
               is replayed with new learning rates written into its
               vector and must follow the plain version at each. Then
               the bf16 rows (``_bf16_cases``): B1 with bf16 x and
               weights and with either one bf16 (fp32 out), B2, B3 (fp32
               acc, m and l) and B4 on bf16 operands at the bf16 phase's
               shapes, each bf16 output within one bf16 ulp plus the fp32
               tolerance of its plain version, timed beside its bound at
               2-byte elements and the library call in bf16.
4. forward  -- ``llama3_8b`` at full width and depth, the Gluon block
               (``HybridBlock``s, ``collect_params()`` names as in the JAX
               package) built by ``get_llama``, ``grad_req='null'`` as a
               served net sets it, and ``initialize(LlamaInit(SEED))``:
               one ``(1, 512)`` forward through the registered ops,
               finite logits, and exactly 65 RMSNorm and 32
               flash-attention launches.
5. serve    -- ``DecodeServer`` with its scheduler thread over six seeded
               prompts (17 to 1500 tokens, two sharing a 64-token prefix),
               32 new tokens each; its warm-up captures the prefill chunk
               and the decode step as CUDA graphs, which every call
               replays, and every paged decode step goes through the
               paged kernel. The server must capture twice and never
               again, and its audit find the pool written in place and
               no allocation in a replayed step. One request is re-run
               teacher-forced through the full forward (the flash path)
               and must pick the same tokens wherever the top-2 logit
               margin exceeds 1e-2; served alone by a server stepped by
               hand it must give the tokens of eager steps at the same
               shapes, and ``generate()`` replaying its decode graph
               those of its eager loop (both timed). Then
               ``torch.profiler`` splits a decode step and a prefill chunk
               into kernel time by name, eager and replayed from a graph;
               a decode step must show one paged-decode kernel event a
               layer; the norm's kernel time in each is logged apart.
6. int8     -- the same net, quantized in place by ``quantize_net`` (naive
               calibration on one seeded (1, 512) batch, bf16
               activations): its 225 ``Dense`` layers become Gluon
               ``QuantizedDense`` layers. One (1, 512)
               forward with exactly 225 int8, 65 norm and 32 flash
               launches; the six prompts served again, with 225 int8
               launches per decode step and per prefill chunk, through
               the graphs as above; ``generate()`` on one prompt. The same
               forward, that prompt's serving and ``generate()`` again
               with every int8 layer through the product's plain version:
               bit-equal logits and the same tokens. The graphs against
               eager calls as above. The teacher-forced check is logged
               only (``int8_checks`` says why); the kernel-time breakdown,
               eager and graphed. Then a small quantized Llama must serve
               the same tokens on the card and the CPU.
7. train    -- ``llama3_8b``'s Gluon block at full width cut to 4 layers
               (1.92 B parameters; fp32 Adam's weights, gradients and two
               moments for all 32 layers would not fit one 80 GB card),
               trained as tests/test_llama.py's loop does (``record()``,
               ``backward()``, ``Trainer(net.collect_params())``): three
               ``Trainer('adam')`` steps, then three of a fresh
               ``Trainer('sgd', momentum=0.9)``, each from the same seeded
               weights (so that the second run has something left to
               learn), on one seeded batch of 2048 tokens. Every loss
               finite and falling, every parameter with a gradient after
               the first backward, exactly 2L+1 norm, L flash and one
               optimizer launch per parameter per step;
               the last step of each run is split into kernel time by
               name. Then a small Llama trains two Adam steps on the card
               and on the CPU, and the losses must agree.
8. ndarray  -- the imperative frontend (``mx.np``/``mx.npx``/``mx.autograd``
               on ``mx.gpu(0)``): ``frontend_loss``, one ``llama3_8b``
               decoder block with the embedding and the LM head (1.27 B
               parameters) written only with ``mx.np``/``mx.npx`` calls,
               recorded and stepped through ``npx.fused_adam_step`` three
               times, then ``npx.fused_sgd_mom_step`` three times from the
               same seeded weights, on one seeded (1, 2049) batch; in
               lockstep the module path (a one-block ``LlamaForCausalLM``
               from copies of the same weights, torch autograd and the
               in-place tensor functions) must give every loss within
               rtol 1e-4 and every weight within atol 1e-5. Each
               imperative step must launch 3 norm, 1 flash and one
               optimizer launch a parameter; the module path's launches
               are taken back off the counters, so the window counts the
               imperative program's. Then one ``npx.paged_attention_decode``
               and one ``nd.quantized_dense`` at decode-step shapes against
               their plain versions. Logged beside the card's name and
               power limit: host ms a step against the module path's, ops
               dispatched a step, host us of ``mx.np.add`` of (4, 4)
               against ``torch.add``, and what the value-semantics copies
               of ``npx.fused_adam_step`` cost over every parameter.
9. bert     -- Gluon: ``bert_12_768_12`` at full width and depth
               (``max_length`` 128, no dropout, no NSP head) on
               ``mx.gpu(0)``, initialized by its own initializers from the
               seed, on one seeded (32, 128) batch of token ids and MLM
               labels (``bench_bert``'s defaults). Three eager forwards,
               then ``hybridize(static_alloc=True)`` and three predict
               calls: one CUDA-graph capture and no other, outputs
               against the eager forward, 26 norm and 12 flash launches a
               call, replays counted. Then ``BERT_STEPS`` steps of
               ``Trainer(net.collect_params(), 'adam')`` under
               ``autograd.record()`` with ``SoftmaxCrossEntropyLoss``, and
               as many of a fresh SGD-momentum Trainer from the same
               weights, each run twice from the same weights: eagerly
               (``hybridize(False)``) and graphed (the recorded call a
               captured forward and backward graph, the update one
               captured graph): losses finite and falling, 26 norm, 12
               flash and ``BERT_UPDATED`` optimizer launches a step in
               both, every parameter but the pooler (no gradient from an
               MLM loss) moved; the graphed run captures 3 graphs for the
               net (predict, forward, backward) and 1 for the Trainer and
               runs no recorded call eagerly; its losses within rtol 1e-4
               of the eager run's and each tensor's change within 1 % of
               the eager change (2-norm); one Adam step of each split
               into kernel time by group; a predict call after training
               replays its graph and sees the new weights. Then the
               graphed node's hazards: a Dense(1024) -> Dropout(0.5) net
               draws a fresh mask every replay (kept share within 1 % of
               0.5 over 1 M values, the input's gradient exactly the mask
               x 2 x the head gradient), two recorded calls of one key
               before one backward (the second runs eagerly, gradients
               equal eager's), and ``create_graph=True`` through a
               replayed call of the Dropout net raises (an eager
               recomputation would draw other masks). Logged: host ms a
               step, samples/s and the busy share, eager and graphed, the
               step's GEMM TFLOP against cuBLAS's measured fp32 rate, the
               plain flash backward, graphed against eager predict ms and
               peak
               memory. Then a small BERT (2 layers, 128 units, 2 heads of
               64) trains two Adam steps on the card and on the CPU, and
               the losses must agree.
10. resnet  -- ResNet-50 training through Gluon's conv layers, the vision
               zoo, ``io`` and ``metric`` (``bench_resnet_train``'s
               imperative loop, bench.py:302-497), with cuDNN's TF32 flag
               left on as PyTorch sets it: one of its convolutions
               through the port's ``Conv2D`` must be fp32 against fp64.
               ``vision.resnet50_v1()`` (1000 classes, full width and
               depth, fp32, seeded) on ``mx.gpu(0)``; 8 seeded batches of
               32 at 3 x 224 x 224 with float labels through
               ``io.NDArrayIter`` put on the card. Three eager forwards,
               then three ``hybridize(static_alloc=True)`` predict calls:
               one capture and one key, outputs equal to the eager ones;
               ``metric.Accuracy`` and ``TopKAccuracy(5)`` on one batch.
               Then ``Trainer(net.collect_params(), 'sgd')`` (lr 0.05,
               momentum 0.9) with ``SoftmaxCrossEntropyLoss``, run eagerly
               (``hybridize(False)``) and then graphed from the same
               weights and statistics with a fresh Trainer: 3 warm-up
               steps, 6 back to back (img/s) and 6 synced one by one (host
               ms a step), each with exactly ``RESNET_UPDATED`` B6
               launches and no other kernel; losses finite; the last step
               split into kernel time by group against the unprofiled
               step before (the busy share); every updated parameter and
               running statistic moved; the graphed warm-up's losses
               within rtol 1e-4 of the eager ones and each tensor's
               three-step change within 1 % of the eager change; 3 graphs
               for the net and 1 for the Trainer, no recorded call run
               eagerly; a predict call after graphed training replays its
               graph and equals an eager forward with the new running
               statistics. The same steps fed by
               ``io.PrefetchingIter(NDArrayIter, ctx=gpu(0), depth=3)``,
               whose first batch must equal ``NDArrayIter``'s. Then
               bench's primary number: K = 24 steps over
               ``pure_function(x0, train=True)`` (log-softmax NLL, B6
               through its device vector), one step captured and replayed
               K times with no host sync between, its first three losses
               within rtol 1e-4 of the same step run eagerly. Logged
               against the step's bound (3 x 7.72 GFLOP an image at the
               fp32 peak) with the card's name and power limit. Then a
               ``resnet18_v1`` thumbnail trains two steps on the card and
               on the CPU: losses within rtol 1e-4, and each weight's and
               running statistic's change within 1 % of the CPU's (2-norm).
11. bf16    -- the reference's default precision (``bench.py --dtype
               bf16``: build, initialize, one forward, ``cast
               ('bfloat16')``, hybridize). ``bert_12_768_12`` at (32, 128)
               in bf16: ``BERT_STEPS`` Adam steps (lr ``BF16_BERT_LR``,
               the MLM logits cast to fp32 for the loss) eagerly and then
               graphed from the same weights, each with exactly 26 B1 and
               12 B2 launches, all bf16 by the profiled step's kernel
               names, no B5 and ``BERT_UPDATED`` plain updates (the
               optimizer's dtype rule), fp32 slots, losses finite and
               falling, graphed against eager at ``BF16_LOSS_RTOL``.
               ``resnet50_v1`` at batch 32 in bf16: graphed predict (K
               forwards back to back), graphed SGD-momentum steps with
               ``RESNET_UPDATED`` plain updates and no kernel, and the K =
               24 loop over ``pure_function``. ``llama3_8b``'s Gluon block
               at full width and depth: one causal (1, 2048) forward in
               fp32, then ``net.cast('bfloat16')`` (16 GB), the same forward with 65 B1 and 32 B2
               launches, all bf16; ``generate()`` of 32 tokens from a
               32-token prompt, teacher-forced through the forward (held
               where the top-2 margin exceeds 0.25). Each path is logged
               beside the fp32 run of the same process (``bf16_costs``:
               host ms, busy share, samples/s, img/s or tok/s, peak memory,
               kernel ms by group). Then a small BERT (two Adam steps) and
               a resnet18 thumbnail (one SGD-momentum step) in bf16 on the
               card and on the CPU: losses at ``BF16_LOSS_RTOL``, the
               weights' change within ``BF16_CHANGE_GAP``.
12. qresnet -- int8 ResNet-50 inference through Gluon quantization
               (``bench_resnet_int8``, bench.py:745-800):
               ``vision.resnet50_v1()`` at full width and depth, fp32,
               seeded, on ``mx.gpu(0)``; its graphed predict at batch 32,
               224, timed in fp32 and, as a bf16 copy of the same weights,
               in bf16; then ``quantization.quantize_net`` in ``naive``
               mode on one seeded batch of 8 at 224 (seeded images, not
               the bench's constant 0.5): 53 ``QuantizedConv2D`` and a
               ``QuantizedDense`` output, bf16 activations. An eager int8
               forward and then ``hybridize(static_alloc=True)`` graphed
               predict, K = 24 calls back to back: exactly 54 B7 launches
               a forward (each convolution one product over its gathered
               windows, and the Dense), one capture and one key, the
               graphed output equal to the eager one bit for bit; then the
               K-step loop over ``pure_function(x, train=False)``, one
               captured forward replayed K times. Logged beside the fp32
               and bf16 predicts: img/s, host and device ms a call, busy
               share, kernel ms by group (B7, cuDNN's convolutions, the
               quantize ops, copies, pooling, BatchNorm and elementwise),
               peak allocated and reserved memory, top-1 of the int8 net
               against the float net. Outside the window, B7 at the
               output Dense's (32, 1000, 2048) and a first-stage 3 x 3
               convolution's gathered shape against its plain version
               (bit-equal, added to the kernel's rows), and that
               convolution through ``quantized_conv2d`` against one
               float64 convolution of the codes (bit-equal). Then a
               ``resnet18_v1`` thumbnail quantized on the card and on the
               CPU from the same weights and calibration batch:
               calibration ranges at rtol 1e-5, int8 weights bit-equal,
               logits within ``QRESNET_LOGIT_TOL`` of the CPU's largest.
13. optim   -- ``bert_12_768_12`` at (32, 128), hybridized, trains
               ``BERT_STEPS`` graphed steps with Adam, AdamW and LAMB from
               the same seeded weights: 26 B1 and 12 B2 launches a step
               (and 156 B5 for Adam; AdamW and LAMB are plain PyTorch, as
               the reference leaves them to XLA), losses finite and
               falling, the net's forward and backward graphs captured
               once and replayed under every Trainer, one update graph a
               Trainer, no recorded call run eagerly. Logged: host ms a
               step, samples/s, busy share, and the update's device ms
               (CUDA events around ``Trainer.step``). Then a small net
               trains two steps with each of the 17 optimizers on the card
               (its update a captured graph) and on the CPU: losses at
               rtol 1e-4, each tensor's change within 1 % (SGLD: the
               first loss only, its noise being each device's own draw).
14. dist    -- data-parallel training over ``torch.distributed``. (a) The
               ``device`` kvstore's replica reduce at bench_kvstore's
               shape (50 keys of 1 M fp32 values, 4 replicas, one out a
               key) on cuda:0: ``fused_pushpull`` timed in a CUDA graph
               against the 1.0 GB it must move, the sum within 1e-6 of
               the largest float64 sum. Then ``DIST_RANKS`` ranks
               (``parallel.launch.spawn``, gloo, all on cuda:0, CUDA
               tensors staged through pinned host buffers), each counted
               from 0 just before and read just after its main path:
               (b) ``bert_12_768_12``'s widths at ``DIST_LAYERS`` (4) of
               its 12 layers (cut to keep the run inside its time
               limit) at (16, 128) a rank (the bert
               phase's 32 sequences split), hybridized, ``BERT_STEPS``
               Adam steps through ``Trainer(..., kvstore='dist_sync')``
               with ``allreduce_grads`` and ``update`` as two calls:
               exactly 10 B1, 4 B2 and 60 B5 a step in each rank, the
               ranks' weights bit-equal after every step, the losses and
               each tensor's change within rtol 1e-4 and 1 % of one
               process over the 32 sequences (``kvstore='device'``,
               ``step(1 / DIST_RANKS)``, since the kvstore sums); (c) the
               same with ``update_on_kvstore=True``, the ZeRO-1 update:
               B5 launches summed over the ranks exactly 60 a step, the
               ranks bit-equal and within 1e-6 of (b)'s weights; (d) a
               2-bit compressed pushpull of ``DIST_GC_SHAPES``: words
               bit-equal to the CPU's, sums exact; (e) SyncBatchNorm on
               8 images over the ranks against one process's BatchNorm
               over the batch: one layer alone at rtol 1e-4 (output,
               gradients, running statistics), and a resnet18 thumbnail
               with SyncBatchNorm layers: logits and running statistics
               at rtol 1e-4, each gradient within 1 % in the 2-norm
               (``dist_sync_bn`` says why), its recorded call run eagerly
               (collectives are not captured).
               Logged beside the card's name and power limit: host ms a
               step split into forward and backward, the all-reduce and
               the update, the update's device ms, MB reduced a step,
               samples/s over both ranks, rank 0's busy share, peak
               memory a rank.
15. dist_async -- the parameter server (``kvstore.create('dist_async')``)
               training ``bert_12_768_12`` at (16, 128) a worker with
               Adam 1e-4 through ``Trainer(kvstore='dist_async',
               update_on_kvstore=True)``, each server updating its
               weights on cuda:0 through B5. (a) One worker and its
               server in this process, 3 steps at BERT-base's widths and
               ``DIST_ASYNC_LAYERS`` (4) layers (cut for time): losses and
               weights bit-equal to a ``kvstore=None`` Trainer's from the
               same weights, with Adam, again under ``DIST_ASYNC_FAULTS``,
               and with SGD-momentum (B6 on the server); 10 B1, 4 B2 and
               60 B5 or B6 a step. (b) Two workers of BERT-base's widths at
               ``DIST_ASYNC_LAYERS`` (4) of its 12 layers (cut to keep the
               run inside its time limit)
               (``parallel.launch.spawn``, both on cuda:0, each process
               holding one of ``MXNET_KVSTORE_NUM_SERVERS=2`` servers, so
               the word embedding and every other key of 1 MB or more is
               split between them), 4 steps: the servers' ``push_applied``
               summed equals workers x steps x (keys + the split keys'
               extra chunks), and so do the B5 launches summed over both
               processes; 10 B1 and 4 B2 in every step of every worker;
               rank 0 captures its forward and backward graphs once, while
               its server applies rank 1's pushes; after a final barrier
               both workers pull bit-equal weights; losses finite and
               falling. (c) (b) again under ``DIST_ASYNC_FAULTS`` (resets
               after the server applied, a seeded lossy link):
               ``push_applied`` exactly the fault-free count, retries
               above 0. (d) Logged beside the card's name and power limit:
               host ms a step split into forward and backward, push, pull
               and the rest, the servers' update device ms (CUDA events
               on each server's stream), MB over the wire, samples/s over
               both workers, rank 0's busy share (its last step profiled
               while rank 1 waits at a barrier), peak memory a process.
16. sharding -- ``mx.sharding`` (one process a rank, gloo ranks sharing
               cuda:0, spawned by ``parallel.launch.spawn``). (a) Two
               ranks serve ``llama3_8b`` at tp = 2, full width cut to 4
               layers (its 32 took 88 s of the run's time limit, its 8
               up to 51 s), against
               a one-process server of those 4, with seeded weights
               (the Gluon block initialized inside the mesh: each rank
               draws each weight whole in turn and keeps its half, placed
               by the ``('llama', 'tp')`` rules as a hybridized Gluon call
               places them), the serve phase's settings and six prompts:
               each
               rank must hold half the weights (``memory_allocated``), 16
               of 32 query and 4 of 8 KV heads, launch exactly 2L + 1 B1
               and L B4 a decode step (9 and 4 at L = 4 layers), never
               re-capture (its calls hold collectives and run eagerly),
               find its pool written in place, and serve the tokens of
               the one-process server (the serve phase's, else served
               here); where they part, the two runs' teacher-forced
               logits must show a near tie (``SHARD_TIE``). (b) Four
               ranks at dp 2 x tp 2 serve the same prompts at
               ``llama3_8b``'s widths and 4 layers, slots and pages split
               on dp, against a one-process 4-layer server. (c) The four
               train ``bert_12_768_12``'s widths at 4 of its 12 layers
               (``SHARD['bert_kw']``, cut to keep the run inside its time
               limit) on the bert phase's (32, 128)
               batch, hybridized, Adam 1e-4, three steps under
               ``mesh(dp=2, tp=2)`` and three under ``mesh(dp=4)``
               (``bert.bert_partition_rules``, ROADMAP C12): losses at
               rtol 1e-4 and each tensor's change within 1 % of one
               process's, the ranks' gathered weights equal, 10 B1, 4
               B2 and 60 B5 a step a rank (B5 summed over the ranks
               equal to the ZeRO-1 plan), slot bytes a quarter of one
               process's a rank. (d) (c)'s dp 2 x tp 2 weights and
               Trainer slots through ``SharedCheckpointManager``, read
               back under ``mesh(dp=4)`` and in one process bit-equal
               (sha256), and a crash at ``ckpt.renamed`` must leave the
               previous step the latest. (e) Per rank: host ms a step
               split into forward, backward and update, the collectives'
               share (staging included), peak memory, rank 0's busy
               share (its last step profiled, every rank running it
               again if the profile lost events).
17. elastic -- ``mx.train``. (a) ``bert_12_768_12``'s widths at
               ``ELASTIC_A['layers']`` (4) of its 12 layers (cut to keep the
               run inside its time limit), (32, 128), fp32, Dropout 0.1,
               Adam, hybridized, batches from a
               shuffled ``DataLoader.resumable()``, in three processes of
               this script (``--elastic-worker``), each under
               ``deterministic``: six steps straight; three with
               ``MXNET_CKPT_ASYNC=1``, saving after each, SIGKILLed
               inside the daemon's save of step 3 (``latest_step()`` must
               be 2); a fresh process that compiles its graphs on a zero
               batch, restores and trains steps 3-6. Weights, Adam slots,
               the update count and the losses must be bit-equal to the
               straight run's; 10 B1, 4 B2, 60 B5 a step. (b) Four
               ranks as two hosts of two (``MeshGroup(2, devices=[0, 1,
               2, 3])``), ``ELASTIC_B['layers']`` layers at BERT-base's
               widths under FSDP through ``MeshElasticTrainer`` over a
               ``dist_async`` store: host 1 dies after step 2 is
               committed, at its barrier of step 3 and, in a second run,
               inside that step's second collective; host 0 must re-form
               on two ranks, restore step 2 re-sharded and finish five
               steps, bit-equal to the planned scale-down (two ranks
               restoring the first run's step-2 checkpoint); logs the
               death-to-first-step seconds (detect, drain, restore,
               rejoin), step ms before and after, launches a rank a step.
18. pipeline -- the 12 ``BERTEncoderCell``s of ``bert_12_768_12`` split
               by ``split_sequential`` into 4 stages over 4 ranks, 8
               microbatches of (8, 128, 768), squared error, Adam, two
               steps each of ``'1f1b'`` and ``'gpipe'``
               (``PipelineTrainer``) against one process running the
               cells eagerly: losses within rtol 1e-4, each stage's first
               step held by ``_pipe_first_step``; 48 B1, 24 B2 and 36 B5 a
               step a stage; step ms and the send/recv share.
19. moe    -- ``parallel.moe_ffn`` at Mixtral-8x7B's FFN widths over ep
               = 4 ranks (0.94 GB of experts a rank), forward and
               backward: the output within rtol 1e-5 of each token shard
               through ep = 1 here, finite gradients; forward and
               backward ms and the all-to-all's share.
20. sparse  -- row-sparse training and the A3 op families
               (``ndarray/sparse.py``, ``Embedding(sparse_grad=True)``,
               the lazy update). (a) ``examples/sparse_embedding.py`` at
               its own sizes: two ``Embedding(1,000,000, 16,
               sparse_grad=True)`` tables from numpy, one seeded batch of
               512 ids each, 40 steps of ``((u . i).sum(-1) - y)**2``'s
               mean, under AdaGrad (lr 0.5), Adam (lr 0.01, lazy) and
               SGD (lr 0.5, momentum 0.9, lazy), each held against the
               same program run by the port on the host from the same
               tables: every loss at rtol 1e-5, the touched rows of both
               tables and their slots at rtol 1e-5 / atol 1e-6 (AdaGrad
               at lr 0.5 at 3e-4 and 3e-3: it amplifies rounding past
               1e-5 on the host alone, which the same run with each
               16-term sum reversed shows, printed beside), and a control
               run with the learning rate moved by 1e-4 must fail that
               check; every other row bit-equal to its start; host ms a
               step over steps 2-40; exactly 2 B5 launches a
               step under Adam and 2 B6 under SGD; a ``row_sparse_pull``
               of 4 rows from a ``'device'`` kvstore is a
               ``RowSparseNDArray`` of (4, 16). (b) ``Embedding(10,000,000,
               64, sparse_grad=True)`` under lazy Adam, 10 steps of 8192
               ids drawn Zipf(1.1): after step 1 the allocated memory
               rises by at most 64 MB over steps 2-10, and over a
               ``row_sparse_pull`` of 1024 rows after the store's
               ``init``; one B5 a step; untouched rows bit-equal; B5 timed
               at the merged-row shape (8192, 64) against its bound (a row
               of the kernels' line). (c) The oracle's 10M x 512 CSR (2
               values a row) on the card: ``dot(csr, v)`` and
               ``dot(csr, out, transpose_a=True)`` against host math,
               ``_dense`` never set, row slicing and scalar math in
               O(nnz); each call's ms against its bytes bound. (d) Every op
               name of the A3 slice (``tests/torch_a3_cases.py``) on CUDA
               inputs against the port on the host at its CPU test's
               tolerance (factors unique up to sign by their invariants),
               every output a CUDA tensor; the gamma-family samplers at
               their moments; ``foreach`` (captured) and ``cond`` with
               ``while_loop`` (decided on the host: eager, counted) in a
               hybridized block, eager and graphed outputs equal.
21. symbol  -- the export path (``HybridBlock.export``, ``mx.sym``,
               ``SymbolBlock``, ``amp.convert_model``), files under
               ``build/symbol/``. (a) ``bert_12_768_12`` (no dropout, no
               NSP head) at the bert phase's (32, 128), hybridized,
               predicts once and is exported (its trace abstract, on meta
               tensors); ``SymbolBlock.imports(..., ctx=mx.gpu(0))``
               predicts the same batch: outputs bit-equal to the Gluon
               net's (else within 1e-6 of the largest value, logged), 26
               B1 and 12 B2 a predict and no other kernel; hybridized, one
               capture over three calls with equal outputs; host ms a
               graphed predict beside the Gluon net's. Then a fresh import
               and the Gluon net from the exported weights train three
               Adam steps in lockstep, both hybridized: 26 B1, 12 B2 and
               156 B5 a step in each, losses and weights bit-equal, else
               the losses at rtol 1e-4 and each tensor's change within 1 %
               of the Gluon net's (2-norm), the Gluon net run twice beside
               (an embedding's backward adds its rows with atomics on the
               card, so two runs of one net part in the last bits). (b)
               ``amp.convert_model`` of that symbol to bf16 by the
               reference's lists (B2 in bf16; ``layer_norm`` is on the
               fp32 list, so B1 stays fp32), and with ``layer_norm`` moved
               to the target list (B1 in bf16 too), each launch's element
               type read from its profiled kernel's name; each converted
               block on the card held to the same converted symbol run by
               the port on the host, on the first ``SYMBOL_BF16_ROWS``
               sequences: each output's largest gap from the host's fp32
               output (over its largest value) at most twice the host's
               bf16 gap plus 1e-3, the card-host gap logged (bf16 rounds
               in other places on each side, and 12 layers carry it to a
               few bf16 ulps); host ms a predict beside (a)'s fp32. (c) The JAX package's committed
               ``tests/fixtures/format/mobilenet0_25`` files imported on
               the card reproduce its recorded output at rtol 1e-4; then
               ``resnet50_v1`` at batch 32 exported and imported: the
               imported block's graphed predict (one capture over three
               calls, no kernel of the eight) equal to the Gluon net's.
               (d) The bulking engine (``mx.engine``): the ndarray phase's
               imperative ``llama3_8b`` block step (:func:`frontend_loss`,
               three Adam steps) eagerly and with its recorded forward
               and backward under ``engine.bulk(n)`` for each n of
               ``SYMBOL_BULK``, from the same weights: the launches of
               every step equal kernel by kernel, losses and weights
               bit-equal (else losses at rtol 1e-4 and each tensor's
               change within 1 %, logged), segment shapes captured in the
               first step only; host ms a step for each. Then chains of
               ``SYMBOL_CHAINS`` elementwise ops on (4, 4096): host us an
               op, eager and bulked (one captured segment a chain,
               replayed), equal results. These figures set bulking's
               default on the card (off: PERF.md).
22. gluon   -- Gluon beyond the core (A5 rest). (a) The HF import: an
               HF-named Llama state dict at ``llama3_8b``'s widths and 2
               layers (bf16, as HF checkpoints ship; rotate-half q and k)
               written as ``pytorch_model.bin`` and as
               ``model.safetensors``, each beside a ``config.json``, under
               ``build/gluon/``, and loaded by ``from_hf_pretrained`` on
               the card with no ``transformers``: a (1, 64) forward's
               logits bit-equal between the two files and to the same
               weights set through ``collect_params()``, within 1e-3 of
               the largest logit of a rotate-half reference forward
               written in plain PyTorch here (``rotate_half_logits``), and
               exactly 5 B1 and 2 B2 launches a forward. (b) A gradient
               penalty (the squared norm of dL/dx) through a hybridized
               MLP whose recorded calls replay: ``create_graph=True``
               through the replayed node gives ``hybridize(False)``'s
               gradients at 1e-5. (c) BERT-base's 12 encoder cells with
               dropout 0.1 at (32, 128), hybridized with and without
               ``remat=True``, the generator reseeded between the capture
               and the replay: the replayed call's gradients from the
               same generator state equal at 1e-5 (the remat backward
               graph draws with the forward's seed and offset), and the
               peak memory of each. (d) ``gluon.contrib.cnn.DeformableConvolution`` at
               (4, 32, 28, 28): its output and gradients on the card
               equal its CPU run at 1e-5 of each tensor's largest value.
23. ring    -- ``parallel.ring_attention`` at ``llama3_8b``'s attention
               widths (32 heads of 128) over its whole 8192 tokens,
               sharded over four ranks (``parallel.launch.spawn``) that
               share cuda:0 over gloo, causal and full. Each rank must
               launch the flash-attention stats kernel exactly r + 1 times
               causal and 4 times full, and returns its counts; the
               gathered output must meet plain dense attention and the
               flash forward over the whole sequence, and the ranks'
               plain blockwise path the flash path. Then the backward on
               the first ``RING_GRAD_HEADS`` heads: under autograd each
               rank launches the same stats kernels, and the gathered q,
               k and v gradients of a seeded cotangent must meet autograd
               through plain dense attention (``ring_grad_checks``). Logs each rank's host ms,
               stats-kernel ms and transport ms.
24. rtc     -- ``rtc.CudaModule`` compiles two kernels written in CUDA C
               (``RTC_SOURCE``: a doubling and one with a scalar argument
               and two outputs) with NVRTC and launches them at (4096,
               14336) fp32: bit-equal to their torch twins, timed against
               the bytes they must move.

The launch counters are set to 0 just before each of the forward, serve,
int8, train, ndarray, bert, resnet, bf16, qresnet, optim, sparse, symbol,
gluon and rtc phases and read just after
it (with the optimizer's plain-update counters), and in each
rank just before and after its ring runs, its dist runs (b) and (c), its
dist_async runs (b) and (c) (the dist_async phase's (a) runs in this
process), its sharding runs (a), (b) and (c), and each process of the
elastic, pipeline and moe phases; the kernels' line
reports their sum. Every profiled call (a
breakdown's step or call) runs in a ``torch.profiler`` session of its own
whose kernel events must equal, kernel by kernel, the launch counters'
change over the session: a short profile is taken again (a training step
from its start, ``Rewind``), at most ``PROFILE_TRIES`` times, and then
fails its phase; the sessions, and those that lost events, are logged at
the end (ROADMAP C5). A CUDA graph's replay counts the launches its capture saw
(``_graphs.StepGraph``). A phase fails if the norm, the int8 product or flash attention (either
form) ran another design than its Hopper ones on its main path
(``NEW_DESIGNS``).
The last line is ``{"ok": true, "device": {...}}``; it is printed only
when every phase ran and passed. Exit code 0 only then.
"""

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ('device', 'build', 'kernels', 'forward', 'serve', 'int8',
          'train', 'ndarray', 'bert', 'resnet', 'bf16', 'qresnet', 'optim',
          'dist', 'dist_async', 'sharding', 'elastic', 'pipeline', 'moe',
          'sparse', 'symbol', 'gluon', 'ring', 'rtc')
SEED = 0    # seeds the generators of the weights, inputs and prompts

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores, and the dense int8
# tensor-core rate (without sparsity).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
INT8_OPS_S = 1979e12
# fp32-accurate products on the TF32 tensor cores: three TF32 products
# (3xTF32) for each, at the data sheet's dense 495 TFLOP/s
TF32X3_OPS_S = 495e12 / 3

KERNELS = {
    'fused_norm': dict(
        source='mxnet_tpu_torch/csrc/fused_norms.cu',
        replaces='mxnet_tpu/ops/pallas/fused_norms.py:27'),
    'flash_attention': dict(
        source='mxnet_tpu_torch/csrc/flash_attention.cu',
        replaces='mxnet_tpu/ops/pallas/flash_attention.py:38'),
    'paged_attention_decode': dict(
        source='mxnet_tpu_torch/csrc/paged_attention.cu',
        replaces='mxnet_tpu/ops/pallas/paged_attention.py:44'),
    'adam': dict(
        source='mxnet_tpu_torch/csrc/fused_optimizer.cu',
        replaces='mxnet_tpu/ops/pallas/fused_optimizer.py:85'),
    'sgd_mom': dict(
        source='mxnet_tpu_torch/csrc/fused_optimizer.cu',
        replaces='mxnet_tpu/ops/pallas/fused_optimizer.py:146'),
    'int8_matmul': dict(
        source='mxnet_tpu_torch/csrc/int8_matmul.cu',
        replaces='mxnet_tpu/ops/pallas/int8_matmul.py:36'),
    'flash_attention_stats': dict(
        source='mxnet_tpu_torch/csrc/flash_attention.cu',
        replaces='mxnet_tpu/ops/pallas/flash_attention.py:168'),
    # a user's CUDA source (RTC_SOURCE below), compiled at run time by
    # mxnet_tpu_torch/rtc.py through NVRTC
    'rtc': dict(
        source='chip_smoke.py',
        replaces='mxnet_tpu/rtc.py:39'),
}
#: the train phase: llama3_8b's widths at this depth, one batch of this
#: many tokens, and the optimizers' settings
TRAIN_LAYERS = 4
TRAIN_TOKENS = 2048
TRAIN_OPTS = (('adam', 'adam', {'learning_rate': 1e-5}),
              ('sgd', 'sgd_mom', {'learning_rate': 0.1, 'momentum': 0.9}))


_ST_NAMES = {'float64': 'F64', 'float32': 'F32', 'float16': 'F16',
             'bfloat16': 'BF16', 'int64': 'I64', 'int32': 'I32',
             'int16': 'I16', 'int8': 'I8', 'uint8': 'U8', 'bool': 'BOOL'}


def write_safetensors(path, tensors):
    """Write ``tensors`` (name -> torch tensor) as a ``.safetensors`` file:
    an 8-byte little-endian header length, the JSON header (each name's
    ``dtype``, ``shape`` and ``data_offsets``), then the raw little-endian
    bytes, as HuggingFace checkpoints hold them (no ``safetensors``
    package)."""
    import torch
    header, chunks, off = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b''
        header[name] = {'dtype': _ST_NAMES[str(t.dtype).split('.')[-1]],
                        'shape': list(t.shape),
                        'data_offsets': [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b' ' * (-len(head) % 8)
    with open(path, 'wb') as f:
        f.write(len(head).to_bytes(8, 'little'))
        f.write(head)
        for raw in chunks:
            f.write(raw)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing
def _events_ms(torch, fn, n):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def eager_ms(torch, fn, budget_ms=100.0):
    """Mean time per call of ``fn()`` launched from Python, by CUDA events
    around a run of calls after warm-up: for a short kernel this is the
    host's launch rate, not the device's time."""
    fn()
    torch.cuda.synchronize()
    n = int(min(200, max(5, budget_ms / max(_events_ms(torch, fn, 1), 1e-3))))
    return _events_ms(torch, fn, n)


@contextlib.contextmanager
def quiet_gc():
    """Python's cyclic collector run before a capture and held off during
    it: it would free the CUDA graphs of an earlier phase whose blocks
    and Trainers are garbage in cycles, and destroying a graph while a
    stream captures invalidates the capture."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def cuda_ms(torch, fn, budget_ms=100.0):
    """Device time per call of ``fn()`` in ms: a run of calls captured in
    one CUDA graph and replayed, timed with CUDA events, so the host's
    launch overhead is not in it. The calls are warmed up on the stream
    that captures them (the split kernels keep their counters per
    stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    n = int(min(100, max(5, budget_ms / max(_events_ms(torch, fn, 1), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with quiet_gc(), torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    t = _events_ms(torch, graph.replay, 3) / n
    del graph
    return t


def bound(nbytes, ops, ops_s=FP32_OPS_S):
    """(bound_ms, bound_by) for work that moves ``nbytes`` and does
    ``ops`` operations at a peak of ``ops_s`` (fp32 by default)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / ops_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def bf16_ulp(torch, t):
    """The spacing of bf16 values at ``|t|`` (2**(e - 7) for a value in
    [2**e, 2**(e + 1)); the least normal's spacing below it), fp64."""
    a = t.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare(torch, got, want, rtol, atol, ulps=0):
    """max |got - want|; fails unless |got - want| <= atol + rtol*|want| +
    ulps bf16 ulps of want everywhere and both are finite, and their
    dtypes agree. ``got``/``want`` may be tuples of tensors (a kernel's
    several outputs), compared pairwise."""
    if isinstance(got, tuple):
        res = [compare(torch, a, b, rtol, atol, ulps)
               for a, b in zip(got, want)]
        return max(e for e, _ in res), len(got) == len(want) and all(
            ok for _, ok in res)
    if got.shape != want.shape or got.dtype != want.dtype:
        log(f'[compare] got {tuple(got.shape)} {got.dtype}, want '
            f'{tuple(want.shape)} {want.dtype}')
        return math.inf, False
    err = (got.double() - want.double()).abs()
    tol = atol + rtol * want.double().abs()
    if ulps:
        tol = tol + ulps * bf16_ulp(torch, want)
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    if not ok:      # say where: the worst element against its tolerance
        over = (err - tol).nan_to_num(math.inf)
        i = int(over.flatten().argmax())
        log(f'[compare] {tuple(got.shape)}: worst element {i}: got '
            f'{float(got.flatten()[i])!r}, want '
            f'{float(want.flatten()[i])!r}, {float(err.flatten()[i]):.3g} '
            f'off, {float(over.flatten()[i]):.3g} past its tolerance; '
            f'finite {bool(torch.isfinite(got).all())}')
    return float(err.max()), ok


# ------------------------------------------------------------- phases
def full_fp32(torch):
    """fp32 products in full fp32, like the reference's Dense layers: the
    flags this process and every rank it spawns run under."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != 'highest':
        fail('fp32 matmuls would run in TF32')


def phase_device(torch):
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a '
             'CUDA card')
    full_fp32(torch)
    log(f'[device] {smi_line()}')
    log(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
        f'devices {torch.cuda.device_count()} '
        f'name {torch.cuda.get_device_name(0)}')


def phase_build():
    from mxnet_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f'[build] {len(_build.sources())} sources, built {sorted(logs)} '
        f'in {time.perf_counter() - t0:.1f} s')
    for name, (_, text) in sorted(logs.items()):
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'[build] {name}: {line.strip()}')


def _case(torch, name, shape, got, want, tol, why, kernel, plain,
          nbytes, ops, library=None, library_call=None, ops_s=FP32_OPS_S,
          path=None, earlier=None, design=None):
    """One row: the check, then the times. ``library_call`` names a
    library call that is timed launched from Python (``eager_ms``), for
    calls that a CUDA graph does not capture as they stand (an optimizer's
    ``step``); other library calls are timed as the kernel is. ``path``
    names the design the kernel's plan took; ``earlier`` is ``(call of
    the earlier design, what it is)``, timed here as the kernel is;
    ``ops_s`` is the card's peak for the operands' type; ``design`` is
    ``(what, ops/s)``, a second bound beside it at another rate (the
    CUDA cores' fp32 rate, or the rate of the design the kernel uses),
    shown after a slash."""
    err, ok = compare(torch, got, want, *tol)
    launched_ms = eager_ms(torch, kernel)
    ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, plain)
    if library is None:
        library_ms = None
    else:
        library_ms = (eager_ms if library_call else cuda_ms)(torch, library)
    bound_ms, bound_by = bound(nbytes, ops, ops_s)
    row = dict(name=name, shape=shape, max_abs_err=err, rtol=tol[0],
               atol=tol[1], bf16_ulps=tol[2] if len(tol) > 2 else 0,
               tolerance_reason=why, ok=ok, ms=ms,
               launched_ms=launched_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms)
    extra = ''
    if path is not None:
        row['path'] = path
        extra += f' path {path}'
    if len(tol) > 2:
        # the error in ulps of the plain value alone, with no absolute
        # term: where it peaks, and how far off that element is
        e = (got.double() - want.double()).abs()
        u = e / bf16_ulp(torch, want)
        i = int(u.flatten().argmax())
        row['max_ulps'] = float(u.flatten()[i])
        row['max_ulps_at'] = [float(want.flatten()[i]), float(e.flatten()[i])]
        row['past_1_ulp'] = int((u > 1).sum())
        extra += (f' ulps of want alone: max {row["max_ulps"]:.0f} at want '
                  f'{row["max_ulps_at"][0]:.3g}, {row["max_ulps_at"][1]:.3g} '
                  f'off; {row["past_1_ulp"]} of {u.numel()} past 1 ulp')
    if design is not None:
        what, rate = design
        row['bound_design_ms'], _ = bound(nbytes, ops, rate)
        row['bound_design'] = f'{what} at {rate / 1e12:g} TFLOP/s'
        extra += f' / {row["bound_design_ms"]:.4f} ({row["bound_design"]})'
    if earlier is not None:
        e_ms, e_from = earlier
        row['earlier_ms'] = cuda_ms(torch, e_ms)
        row['earlier_from'] = e_from
        extra += f' earlier_ms {row["earlier_ms"]:.4f} ({e_from})'
    if library_call:
        row['library_call'] = library_call
    lib = 'none' if library_ms is None else f'{library_ms:.4f}'
    if library_call:
        lib += f' ({library_call}, launched from Python)'
    ulp = f' + {tol[2]} bf16 ulp' if len(tol) > 2 else ''
    log(f'[kernels] {name} {shape}: max_abs_err {err:.3e} '
        f'(rtol {tol[0]:g}, atol {tol[1]:g}{ulp}: {why}) kernel_ms {ms:.4f} '
        f'(launched from Python {launched_ms:.4f}) '
        f'plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})'
        f'{extra} library_ms {lib} -> {"ok" if ok else "MISMATCH"}')
    return row


def phase_kernels(torch):
    """Every kernel against its plain version; returns {kernel: [rows]}."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.kernels import flash_attention

    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    rows = {k: [] for k in KERNELS}
    f4 = 4   # bytes per fp32 value

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _norm_cases(torch, randn, rows['fused_norm'], sms)

    # ---- flash attention forward: fp32-accurate, 3xTF32 on the tensor
    # cores; the keys split where the grid is short (T against a long S)
    att_tol = (1e-4, 1e-4)
    att_why = 'fp32 online softmax vs one-pass softmax, sums over S keys ' \
              'in another order; products in 3xTF32'
    llama = ((512, 512, 128, True), (512, 512, 128, False),
             (2048, 2048, 128, True), (2048, 2048, 128, False),
             (37, 2048, 128, True), (1, 2048, 128, True),
             (64, 2048, 128, True), (65, 2048, 128, True),
             (2048, 2048, 64, True), (2048, 2048, 32, True))
    # BERT-base: a (32, 128) batch of 12 heads of 64, and (8, 512)
    bert = ((384, 128, 128, 64, False), (96, 512, 512, 64, False))
    for bh, t, s, d, causal in [(32,) + c for c in llama] + list(bert):
        q, k, v = randn(bh, t, d), randn(bh, s, d), randn(bh, s, d)
        scale = d ** -0.5
        got = flash_attention.flash_attention_fwd(q, k, v, scale, causal)
        want = flash_attention.flash_attention_plain(q, k, v, scale, causal)
        # (query, key) pairs the function needs: bottom-right causal keeps
        # key j for query i when j <= S - T + i
        pairs = sum(min(s, s - t + i + 1) for i in range(t)) if causal \
            else t * s
        ops = 4 * bh * pairs * d
        nbytes = f4 * bh * d * (2 * t + 2 * s)
        q4, k4, v4 = q[None], k[None], v[None]
        if t == s or not causal:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, is_causal=causal)
        else:   # SDPA's is_causal is top-left: pass the bottom-right mask
            mask = torch.ones(t, s, dtype=torch.bool, device=dev).tril(s - t)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, attn_mask=mask)
        rows['flash_attention'].append(_case(
            torch, 'flash_attention',
            f'BH={bh} T={t} S={s} d={d} {"causal" if causal else "full"}',
            got, want, att_tol, att_why,
            lambda: flash_attention.flash_attention_fwd(q, k, v, scale,
                                                        causal),
            lambda: flash_attention.flash_attention_plain(q, k, v, scale,
                                                          causal),
            nbytes, ops, lib, ops_s=TF32X3_OPS_S,
            design=('fp32 on the CUDA cores', FP32_OPS_S),
            path=flash_attention.plan(bh, t, s, d, sms).path))
        del got, want
    del q, k, v
    _stats_cases(torch, randn, rows)

    _paged_cases(torch, randn, rows, sms)

    _bf16_cases(torch, randn, rows, sms)

    _optimizer_cases(torch, randn, rows)
    _vector_replay_check(torch, randn)
    _int8_cases(torch, dev, rows)
    grads_ok = _gradient_checks(torch, randn)

    bad = [r for rs in rows.values() for r in rs if not r['ok']]
    if not grads_ok:
        fail('a gradient through the kernels disagrees with autograd '
             'through the plain versions')
    if bad:
        fail(f'{len(bad)} kernel check(s) disagree with the plain version: '
             f'{[(r["name"], r["shape"]) for r in bad]}')
    return rows


def _norm_cases(torch, randn, rows, sms):
    """The fused norm against its plain version, RMS and LayerNorm, at a
    decode step's (4, 4096), a prefill chunk's (32, 4096), (512, 4096) and
    a training batch's (2048, 4096), and LayerNorm at BERT-base's (512,
    768) and (4096, 768), eps 1e-12. Each row names the design its plan took; the earlier design
    (``general``, forced) is held to the plain version too and timed
    beside it. Then the floors (``_norm_floors``). The library call is
    ``F.rms_norm`` or ``F.layer_norm``."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.kernels import fused_norms as fn
    tol = (1e-5, 1e-5)
    why = 'fp32 statistics, sums over d taken in another order'
    general = fn.Plan('general', fn.GENERAL_THREADS, 0, 1)
    # BERT-base's LayerNorm at a (32, 128) batch takes its eps, 1e-12
    cases = [(n, 4096, rms, 1e-5) for n in (4, 32, 512, 2048)
             for rms in (True, False)] + [(512, 768, False, 1e-5),
                                          (4096, 768, False, 1e-12)]
    for n, d, rms, eps in cases:
        if rms or d != 4096:        # new inputs for each shape
            x = randn(n, d, scale=2.0) + 0.3
            g, b = randn(d) + 1.0, randn(d)
        beta = None if rms else b
        got = fn.fused_norm(x, g, beta, eps, rms)
        want = fn.fused_norm_plain(x, g, beta, eps, rms)
        out_old = torch.empty_like(x)

        def old():
            fn._launch(x, g, beta, out_old, eps, rms, general)
        old()
        err, ok = compare(torch, out_old, want, *tol)
        if not ok:
            fail(f'fused_norm: the general design differs from the plain '
                 f'version at ({n}, {d}), rms {rms}: {err:.3g}')
        if rms:
            lib = lambda: F.rms_norm(x, (d,), g, eps)  # noqa: E731
        else:
            lib = lambda: F.layer_norm(x, (d,), g, beta, eps)  # noqa
        rows.append(_case(
            torch, 'fused_norm', f'{"rms" if rms else "layer"} ({n}, {d})'
            f'{" eps 1e-12" if eps != 1e-5 else ""}',
            got, want, tol, why,
            lambda: fn.fused_norm(x, g, beta, eps, rms),
            lambda: fn.fused_norm_plain(x, g, beta, eps, rms),
            4 * (2 * n * d + d * (1 if rms else 2)), (4 if rms else 6) * n * d,
            lib, path=fn.plan(n, d, True, sms, rms).path,
            earlier=(old, 'general design, this run')))
    del x, g, b, got, want, out_old
    _norm_floors(torch, randn, rows, sms)


FLOOR_SOURCE = r'''
extern "C" __global__ void empty_kernel(int* unused) {}

// The norm's copy floor: the regs design's grid and block at d = 4096 (one
// block of 256 threads a row, four 16-byte vectors a thread, every load
// issued first, the weights with ld.relaxed.cta as there), writing
// x * gamma with no reduction.
extern "C" __global__ void __launch_bounds__(256)
copy_floor(const float* x, const float* gamma, int nv, float* y) {
  const float4* xr = reinterpret_cast<const float4*>(x) +
                     static_cast<unsigned long long>(blockIdx.x) * nv;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  float4* yr = reinterpret_cast<float4*>(y) +
               static_cast<unsigned long long>(blockIdx.x) * nv;
  float4 a[4], b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4* p = xr + min(k * 256 + int(threadIdx.x), nv - 1);
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(a[k].x), "=f"(a[k].y), "=f"(a[k].z), "=f"(a[k].w)
                 : "l"(p));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4* p = g4 + min(k * 256 + int(threadIdx.x), nv - 1);
    asm volatile("ld.relaxed.cta.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(b[k].x), "=f"(b[k].y), "=f"(b[k].z), "=f"(b[k].w)
                 : "l"(p));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = k * 256 + threadIdx.x;
    if (j < nv)
      yr[j] = make_float4(a[k].x * b[k].x, a[k].y * b[k].y, a[k].z * b[k].z,
                          a[k].w * b[k].w);
  }
}
'''


def _turns(torch, calls, rounds=5):
    """``{name: ms}``: each call's least ``cuda_ms`` over ``rounds`` rounds
    that time the calls in turns, so that a change of the card's clocks
    during the rounds (on the H100 an empty kernel's time has moved by a
    fifth within one run) falls on every call alike."""
    best = dict.fromkeys(calls, math.inf)
    for _ in range(rounds):
        for name, fn in calls.items():
            best[name] = min(best[name], cuda_ms(torch, fn))
    return best


def _norm_floors(torch, randn, rows, sms):
    """What the norm's rows at (4, 4096) and (32, 4096) are held against:
    the launch floor (an empty kernel, one block of 32 threads) and the
    copy floor (``copy_floor``: the regs design's grid and block reading x
    and gamma and writing x * gamma, no reduction), both compiled through
    ``rtc``; the copy floor must give torch's x * gamma bit for bit. At
    each shape every design that takes it (``cluster`` and ``regs``, which
    the plans take, and the earlier ``general``) is held to the plain
    version, RMS and LayerNorm, and timed in turns with both floors
    (``_turns``); each row there gets those times and its multiples of
    both floors."""
    from mxnet_tpu_torch.ops.kernels import fused_norms as fn
    from mxnet_tpu_torch.rtc import CudaModule
    floors = CudaModule(FLOOR_SOURCE)
    empty = floors.get_kernel('empty_kernel')
    copy = floors.get_kernel('copy_floor')
    d = 4096
    for n in (4, 32):
        x, g, b = randn(n, d, scale=2.0) + 0.3, randn(d) + 1.0, randn(d)
        args = [x, g, d // 4]
        if not torch.equal(copy.launch(args, (n,), 256, [(n, d)])[0], x * g):
            fail(f'the copy floor kernel is wrong at ({n}, {d})')
        out = torch.empty_like(x)
        calls = {'launch floor': lambda: empty.launch([], (1,), 32, (1,)),
                 'copy floor': lambda: copy.launch(args, (n,), 256,
                                                   [(n, d)])}
        designs = {'cluster': fn.plan(n, d, True, sms, True),    # RMS's
                   'regs': fn.plan(n, d, True, sms, False),      # LN's
                   'general': fn.Plan('general', fn.GENERAL_THREADS, 0, 1)}
        for rms in (True, False):
            beta = None if rms else b
            kind = 'rms' if rms else 'layer'
            want = fn.fused_norm_plain(x, g, beta, 1e-5, rms)
            for name, p in designs.items():
                fn._launch(x, g, beta, out, 1e-5, rms, p)
                err, ok = compare(torch, out, want, 1e-5, 1e-5)
                if not ok:
                    fail(f'fused_norm: the {name} design differs from the '
                         f'plain version at ({n}, {d}), {kind}: {err:.3g}')
                calls[f'{kind} {name}'] = \
                    lambda beta=beta, rms=rms, p=p: fn._launch(
                        x, g, beta, out, 1e-5, rms, p)
        ms = _turns(torch, calls)
        log(f'[kernels] norm at ({n}, {d}), the least of 5 rounds in turns '
            f'({designs["cluster"]}, {designs["regs"]}): '
            + ', '.join(f'{k} {v:.5f}' for k, v in ms.items()) + ' ms')
        for row in rows:
            if not row['shape'].endswith(f'({n}, {d})'):
                continue
            kind = row['shape'].split()[0]
            new = ms[f'{kind} {row["path"]}']
            row.update(turns_ms=ms, launch_floor_multiple=new / ms[
                'launch floor'], copy_floor_multiple=new / ms['copy floor'])
            log(f'[kernels] fused_norm {row["shape"]}: {row["path"]} '
                f'{new:.5f} ms in turns, {row["launch_floor_multiple"]:.2f} '
                f'x the launch floor, {row["copy_floor_multiple"]:.2f} x the '
                f'copy floor; cluster {ms[f"{kind} cluster"]:.5f}, regs '
                f'{ms[f"{kind} regs"]:.5f}, general '
                f'{ms[f"{kind} general"]:.5f}')
        del x, g, b, args, out, calls


def _paged_cases(torch, randn, rows, sms):
    """Paged decode against its plain version at the serving shapes (4
    slots, llama3_8b's 8 KV heads of 128 with 4 query heads each, pages of
    16, 128 pages a row): first a decode step's own, every row at depth
    1024; then mixed depths with a retired row of garbage pages; then a
    table of 8 pages. The first two also time the kernel at half and twice
    the plan's split count. Last, one call captured in a CUDA graph whose
    offsets and block table are then rewritten in place (a dead row, a
    depth-0 row): the replay must meet the plain version at the new
    values, as a graph of the decode step will rely on."""
    import ctypes
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import paged_attention as pa
    smem = _build.function('paged_attention', 'paged_attention_smem_bytes',
                           [ctypes.c_int] * 3)
    for bf, what in ((0, 'fp32'), (1, 'bf16')):
        by = {(d, g): smem(d, g, bf) for d in pa.HEAD_DIMS
              for g in pa.GROUPS}
        log(f'[kernels] paged_attention_decode shared memory a block, '
            f'bytes, by (head dim, group), {what}: {by}')
    kv, G, dh, psz = 8, 4, 128, 16
    tol, why = (1e-4, 1e-4), ('fp32 online softmax across tiles vs '
                              'one-pass softmax over the gathered cache')
    scale = dh ** -0.5

    def inputs(B, NP, depths, garbage_row=None):
        P = B * NP + 1
        q = randn(B, kv, G, dh)
        kp, vp = randn(P, psz, kv, dh), randn(P, psz, kv, dh)
        perm = torch.randperm(P - 1,
                              generator=torch.Generator().manual_seed(1))
        pages = (perm[:B * NP] + 1).reshape(B, NP).to(torch.int32)
        if garbage_row is not None:
            pages[garbage_row] = 0
        return q, kp, vp, pages.to(q.device), torch.tensor(
            depths, dtype=torch.int32, device=q.device)

    def cost(B, pages, depths):
        live = sum(o + 1 for o in depths)      # positions the rows read
        nbytes = 4 * (2 * live * kv * dh + 2 * B * kv * G * dh) \
            + 4 * (pages.numel() + B)
        return nbytes, 4 * live * kv * G * dh

    for B, NP, depths, garbage in ((4, 128, [1024] * 4, None),
                                   (4, 128, [1, 700, 2047, 0], 3),
                                   (3, 8, [0, 37, 127], None)):
        q, kp, vp, pages, offset = inputs(B, NP, depths, garbage)
        got = pa.paged_attention_decode(q, kp, vp, pages, offset, scale)
        want = pa.paged_attention_decode_plain(q, kp, vp, pages, offset,
                                               scale)
        splits = pa.plan(B, kv, NP, psz, sms)
        row = _case(
            torch, 'paged_attention_decode',
            f'B={B} kv={kv} G={G} dh={dh} page={psz} pages/seq={NP} '
            f'depths={depths}' + ('' if garbage is None else
                                  f' (row {garbage} all garbage)'),
            got, want, tol, why,
            lambda: pa.paged_attention_decode(q, kp, vp, pages, offset,
                                              scale),
            lambda: pa.paged_attention_decode_plain(q, kp, vp, pages,
                                                    offset, scale),
            *cost(B, pages, depths), None, path=f'splits{splits}')
        if NP == 128:       # the plan's count against its neighbours
            out = torch.empty_like(q)
            row['splits_ms'] = {
                n: cuda_ms(torch, lambda n=n: pa._launch(
                    q, kp, vp, pages, offset, out, scale, n))
                for n in sorted({max(1, splits // 2), splits,
                                 min(pa.MAX_SPLITS, 2 * splits)})}
            log(f'[kernels] paged_attention_decode by split count, ms: '
                f'{row["splits_ms"]}')
        rows['paged_attention_decode'].append(row)

    # the graph case: captured at depth 1024, replayed at other depths
    q, kp, vp, pages, offset = inputs(4, 128, [1024] * 4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention_decode(q, kp, vp, pages, offset, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with quiet_gc(), torch.cuda.graph(graph, stream=side):
        out = pa.paged_attention_decode(q, kp, vp, pages, offset, scale)
    depths = [2047, 0, 300, 0]
    new_pages = pages.flip(0).clone()
    new_pages[3] = 0                            # a retired row
    pages.copy_(new_pages)
    offset.copy_(torch.tensor(depths, dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want = pa.paged_attention_decode_plain(q, kp, vp, pages, offset, scale)
    rows['paged_attention_decode'].append(_case(
        torch, 'paged_attention_decode',
        f'CUDA graph captured at depths [1024]*4, replayed after offset and '
        f'pages were rewritten in place: depths={depths} (row 3 all '
        f'garbage); timed as the wrapper at those values', out, want, tol,
        why, lambda: pa.paged_attention_decode(q, kp, vp, pages, offset,
                                               scale),
        lambda: pa.paged_attention_decode_plain(q, kp, vp, pages, offset,
                                                scale),
        *cost(4, pages, depths), None,
        path=f'splits{pa.plan(4, kv, 128, psz, sms)}'))
    del graph, q, kp, vp, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _stats_cases(torch, randn, rows):
    """The flash-attention stats kernel (acc, m, l) against its plain
    version: the ring's blocks at llama3_8b's attention widths (BH 32,
    2048 tokens a rank, d 128), full first (the block most launched on the
    main path), then diagonal, then a ragged case. No one PyTorch call
    returns (acc, m, l): the library time is that of the nearest, the
    memory-efficient SDPA kernel with its log-sum-exp (out and lse, fp32),
    timed only and not the same function."""
    from mxnet_tpu_torch.ops.kernels import flash_attention
    f4 = 4
    tol = (1e-4, 1e-4)
    why = ('fp32 online softmax vs one-pass softmax; m from (q*scale)k vs '
           '(qk)*scale; products in 3xTF32')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bh, t, d, causal in ((32, 2048, 128, False), (32, 2048, 128, True),
                             (12, 1000, 64, True)):
        q, k, v = randn(bh, t, d), randn(bh, t, d), randn(bh, t, d)
        scale = d ** -0.5
        got = flash_attention.flash_attention_stats(q, k, v, scale, causal)
        want = flash_attention.flash_attention_stats_plain(q, k, v, scale,
                                                           causal)
        pairs = t * (t + 1) // 2 if causal else t * t
        ops = 4 * bh * pairs * d
        nbytes = f4 * bh * (4 * t * d + 2 * t)
        q4, k4, v4 = q[None], k[None], v[None]

        def lib():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True, 0.0, causal)
        try:
            lib()
        except RuntimeError as e:           # the yardstick only
            log(f'[kernels] efficient SDPA refused: '
                f'{str(e).splitlines()[0]}')
            lib = None
        rows['flash_attention_stats'].append(_case(
            torch, 'flash_attention_stats',
            f'BH={bh} T=S={t} d={d} {"diagonal" if causal else "full"}',
            got, want, tol, why,
            lambda: flash_attention.flash_attention_stats(q, k, v, scale,
                                                          causal),
            lambda: flash_attention.flash_attention_stats_plain(
                q, k, v, scale, causal),
            nbytes, ops, lib, ops_s=TF32X3_OPS_S,
            design=('fp32 on the CUDA cores', FP32_OPS_S),
            path=flash_attention.plan(bh, t, t, d, sms).path))
        del q, k, v, got, want, q4, k4, v4, lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


#: the bound that bf16 outputs are held to: one bf16 ulp of the plain
#: version's value (each side rounds its fp32 result once, half an ulp
#: apiece) plus the fp32 kernel's own tolerance before that rounding,
#: which decides where the rounded values differ by more than an ulp
#: (values near zero, where cancellation leaves the fp32 difference above
#: the value's ulp)
BF16_ULPS = 1
#: bytes a bf16 element
BF2 = 2
#: the card's dense bf16 tensor-core rate (the data sheet's 989 TFLOP/s):
#: B2/B3's bound on bf16 operands, since a bf16 MMA with fp32 accumulation
#: takes QK^T exactly (the scale applied after) and P V to 1e-4 in two
#: bf16 products
BF16_OPS_S = 989e12
#: the rate of the design B2/B3 use on bf16: each product takes two TF32
#: tensor-core products (a bf16 k or v is exact in TF32, so its low half
#: is zero), shown beside the bound
TF32X2_OPS_S = 495e12 / 2
TF32X2 = ('the design used, 2xTF32', TF32X2_OPS_S)


def _bf16_cases(torch, randn, rows, sms):
    """The bf16 kernels against their plain versions at the bf16 phase's
    shapes, timed beside their bound (2-byte elements at 3.35 TB/s, or
    operations at the card's bf16 tensor-core rate for B2/B3/B4, with the
    rate of the design used after a slash) and the library call in
    bf16: B1 with bf16 x and weights (RMS at llama3_8b's (2048 / 32 / 4,
    4096), LayerNorm at BERT-base's (4096, 768), eps 1e-12) and with the
    two mixed pairs (fp32 out); B2 at BERT-base's BH 384, T = S = 128, d
    64, llama's BH 32, T = S = 2048, d 128, causal, and T = 37, S = 2048
    (SDPA in bf16 is a looser function: it rounds P to bf16 before P V);
    B3 at BH 32, T = S = 2048, d 128, full and diagonal (fp32 acc at the
    fp32 tolerance, m within 3e-6, l within 1e-5: a sum of 2048
    exponentials taken by exp2f on the card and by exp in the plain
    version, in other orders, of which 2.9e-6 was seen); B4 with bf16 q
    and pool at a decode step's shape and at mixed depths."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.ops.kernels import fused_norms as fn
    from mxnet_tpu_torch.ops.kernels import paged_attention as pa
    bf, f32 = torch.bfloat16, torch.float32
    ulp_why = ('1 bf16 ulp (one rounding of each fp32 result) plus the fp32 '
               'kernel\'s tolerance')
    # ---- B1
    ntol = (1e-5, 1e-5, BF16_ULPS)
    for n, d, rms, eps, xt, wt in (
            (2048, 4096, True, 1e-5, bf, bf), (32, 4096, True, 1e-5, bf, bf),
            (4, 4096, True, 1e-5, bf, bf), (4096, 768, False, 1e-12, bf, bf),
            (2048, 4096, True, 1e-5, bf, f32),
            (4096, 768, False, 1e-12, f32, bf)):
        x = (randn(n, d, scale=2.0) + 0.3).to(xt)
        g = (randn(d) + 1.0).to(wt)
        beta = None if rms else randn(d).to(wt)
        got = fn.fused_norm(x, g, beta, eps, rms)
        want = fn.fused_norm_plain(x, g, beta, eps, rms)
        lib = None
        if xt == wt:
            if rms:
                lib = lambda: F.rms_norm(x, (d,), g, eps)  # noqa: E731
            else:
                lib = lambda: F.layer_norm(x, (d,), g, beta, eps)  # noqa
        nbytes = (x.element_size() + got.element_size()) * n * d \
            + g.element_size() * d * (1 if rms else 2)
        rows['fused_norm'].append(_case(
            torch, 'fused_norm',
            f'bf16: {"rms" if rms else "layer"} ({n}, {d}) x {xt} weights '
            f'{wt} -> {got.dtype}{" eps 1e-12" if eps != 1e-5 else ""}',
            got, want, ntol, ulp_why + ' (1e-5, fp32 statistics)',
            lambda: fn.fused_norm(x, g, beta, eps, rms),
            lambda: fn.fused_norm_plain(x, g, beta, eps, rms),
            nbytes, (4 if rms else 6) * n * d, lib,
            path=fn.plan(n, d, True, sms, rms, 16 // x.element_size()).path))
        del x, g, beta, got, want, lib
    # ---- B2
    atol = (1e-4, 1e-4, BF16_ULPS)
    for bh, t, s, d, causal in ((384, 128, 128, 64, False),
                                (32, 2048, 2048, 128, True),
                                (32, 37, 2048, 128, True)):
        q, k, v = (randn(bh, n_, d).to(bf) for n_ in (t, s, s))
        scale = d ** -0.5
        got = fa.flash_attention_fwd(q, k, v, scale, causal)
        want = fa.flash_attention_plain(q, k, v, scale, causal)
        pairs = sum(min(s, s - t + i + 1) for i in range(t)) if causal \
            else t * s
        q4, k4, v4 = q[None], k[None], v[None]
        if t == s or not causal:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, is_causal=causal)
        else:
            mask = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(
                s - t)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, attn_mask=mask)
        rows['flash_attention'].append(_case(
            torch, 'flash_attention',
            f'bf16: BH={bh} T={t} S={s} d={d} '
            f'{"causal" if causal else "full"}',
            got, want, atol, ulp_why + ' (1e-4: online softmax, 2xTF32)',
            lambda: fa.flash_attention_fwd(q, k, v, scale, causal),
            lambda: fa.flash_attention_plain(q, k, v, scale, causal),
            BF2 * bh * d * (2 * t + 2 * s), 4 * bh * pairs * d, lib,
            ops_s=BF16_OPS_S, design=TF32X2,
            path=fa.plan(bh, t, s, d, sms).path))
        del q, k, v, got, want, q4, k4, v4, lib
    # ---- B3
    for causal in (False, True):
        bh, t, d = 32, 2048, 128
        q, k, v = (randn(bh, t, d).to(bf) for _ in range(3))
        scale = d ** -0.5
        got = fa.flash_attention_stats(q, k, v, scale, causal)
        want = fa.flash_attention_stats_plain(q, k, v, scale, causal)
        ml = [compare(torch, got[1], want[1], 3e-6, 3e-6),
              compare(torch, got[2], want[2], 1e-5, 1e-5)]
        log(f'[kernels] flash_attention_stats bf16 BH={bh} T=S={t} d={d} '
            f'{"diagonal" if causal else "full"}: m max_abs_err '
            f'{ml[0][0]:.3e} (3e-6), l {ml[1][0]:.3e} (1e-5), both fp32 -> '
            f'{"ok" if all(ok for _, ok in ml) else "MISMATCH"}')
        row = _case(
            torch, 'flash_attention_stats',
            f'bf16: BH={bh} T=S={t} d={d} {"diagonal" if causal else "full"}'
            f' (acc, m, l fp32; acc shown)',
            got[0], want[0], (1e-4, 1e-4),
            'fp32 acc as the fp32 form (online softmax, 2xTF32)',
            lambda: fa.flash_attention_stats(q, k, v, scale, causal),
            lambda: fa.flash_attention_stats_plain(q, k, v, scale, causal),
            BF2 * 3 * bh * t * d + 4 * bh * t * (d + 2),
            4 * bh * (t * (t + 1) // 2 if causal else t * t) * d, None,
            ops_s=BF16_OPS_S, design=TF32X2,
            path=fa.plan(bh, t, t, d, sms).path)
        row['ok'] = row['ok'] and all(ok for _, ok in ml)
        row['m_l_err'] = [e for e, _ in ml]
        rows['flash_attention_stats'].append(row)
        del q, k, v, got, want
    # ---- B4
    kv, G, dh, psz = 8, 4, 128, 16
    for B, NP, depths in ((4, 128, [1024] * 4), (4, 128, [1, 700, 2047, 0])):
        P = B * NP + 1
        q = randn(B, kv, G, dh).to(bf)
        kp, vp = (randn(P, psz, kv, dh).to(bf) for _ in range(2))
        perm = torch.randperm(P - 1,
                              generator=torch.Generator().manual_seed(1))
        pages = (perm[:B * NP] + 1).reshape(B, NP).to(torch.int32).to(
            q.device)
        offset = torch.tensor(depths, dtype=torch.int32, device=q.device)
        scale = dh ** -0.5
        got = pa.paged_attention_decode(q, kp, vp, pages, offset, scale)
        want = pa.paged_attention_decode_plain(q, kp, vp, pages, offset,
                                               scale)
        live = sum(o + 1 for o in depths)
        rows['paged_attention_decode'].append(_case(
            torch, 'paged_attention_decode',
            f'bf16: B={B} kv={kv} G={G} dh={dh} page={psz} pages/seq={NP} '
            f'depths={depths}', got, want, atol,
            ulp_why + ' (1e-4: online softmax across tiles)',
            lambda: pa.paged_attention_decode(q, kp, vp, pages, offset,
                                              scale),
            lambda: pa.paged_attention_decode_plain(q, kp, vp, pages,
                                                    offset, scale),
            BF2 * (2 * live * kv * dh + 2 * B * kv * G * dh)
            + 4 * (pages.numel() + B), 4 * live * kv * G * dh, None,
            ops_s=BF16_OPS_S, design=('fp32 on the CUDA cores', FP32_OPS_S),
            path=f'splits{pa.plan(B, kv, NP, psz, sms)}'))
        del q, kp, vp, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _optimizer_cases(torch, randn, rows):
    """Adam and SGD-momentum against their plain versions, each on its own
    copy of the same weight and slots: an MLP weight (the first case), the
    embedding, a norm weight and a ragged size, at t = 1 and t = 1000. The
    library call is one ``step()`` of ``torch.optim``'s fused optimizer,
    timed only."""
    from mxnet_tpu_torch.ops.kernels import fused_optimizer as fo
    tol = (1e-6, 1e-7)
    why = 'fp32, the same operations in the same order, none contracted'
    lr, wd, clip = 1e-3, 0.01, dict(rescale_grad=0.5, clip_gradient=1.0)
    betas = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)
    for shape in ((4096, 14336), (128256, 4096), (4096,), (1000,),
                  (512, 512, 3, 3)):
        n = math.prod(shape)
        w, g = randn(*shape), randn(*shape, scale=3.0)   # the clip bites
        m, v = randn(*shape, scale=0.1), randn(*shape, scale=0.1).square()
        for t in (1, 1000):
            vec = torch.tensor([lr, wd, 1 - 0.9 ** t, 1 - 0.999 ** t],
                               device=w.device)
            kw = dict(**betas, **clip)
            ks = [x.clone() for x in (w, m, v)]
            ps = [x.clone() for x in (w, m, v)]
            got = fo.adam_step(ks[0], g, ks[1], ks[2], vec, **kw)
            want = fo.adam_step_plain(ps[0], g, ps[1], ps[2], vec, **kw)
            lib = None
            if t == 1:
                p = torch.nn.Parameter(w.clone())
                p.grad = g
                adam = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=wd,
                                        fused=True)
                lib = adam.step
            rows['adam'].append(_case(
                torch, 'adam', f'{shape} t={t}', got, want, tol, why,
                lambda: fo.adam_step(ks[0], g, ks[1], ks[2], vec, **kw),
                lambda: fo.adam_step_plain(ps[0], g, ps[1], ps[2], vec,
                                           **kw),
                28 * n, 18 * n, lib,
                library_call=lib and 'torch.optim.Adam(fused=True).step'))
            del ks, ps, got, want, lib
            if t == 1:
                del p, adam

            ks = [x.clone() for x in (w, m)]
            ps = [x.clone() for x in (w, m)]
            got = fo.sgd_mom_step(ks[0], g, ks[1], vec, momentum=0.9,
                                  **clip)
            want = fo.sgd_mom_step_plain(ps[0], g, ps[1], vec,
                                         momentum=0.9, **clip)
            lib = call = None
            if t == 1:
                p = torch.nn.Parameter(w.clone())
                p.grad = g
                try:
                    sgd = torch.optim.SGD([p], lr=lr, momentum=0.9,
                                          weight_decay=wd, fused=True)
                    call = 'torch.optim.SGD(fused=True).step'
                except (TypeError, RuntimeError, ValueError):
                    sgd = torch.optim.SGD([p], lr=lr, momentum=0.9,
                                          weight_decay=wd, foreach=True)
                    call = 'torch.optim.SGD(foreach=True).step'
                lib = sgd.step
            rows['sgd_mom'].append(_case(
                torch, 'sgd_mom', f'{shape} t={t}', got, want, tol, why,
                lambda: fo.sgd_mom_step(ks[0], g, ks[1], vec,
                                        momentum=0.9, **clip),
                lambda: fo.sgd_mom_step_plain(ps[0], g, ps[1], vec,
                                              momentum=0.9, **clip),
                20 * n, 7 * n, lib, library_call=call))
            del ks, ps, got, want, lib
            if t == 1:
                del p, sgd
        del w, g, m, v
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _vector_replay_check(torch, randn):
    """An SGD-momentum update captured in a CUDA graph reads its
    hyperparameter vector when it replays: a learning rate written into
    the vector between replays changes the update as it changes the plain
    version's."""
    from mxnet_tpu_torch import _graphs
    from mxnet_tpu_torch.ops.kernels import fused_optimizer as fo
    w, g, mom = randn(4096), randn(4096), randn(4096, scale=0.1)
    vec = torch.tensor([1e-3, 1e-2], device=w.device)
    ks, ps = [w.clone(), mom.clone()], [w.clone(), mom.clone()]
    graph = _graphs.StepGraph(lambda: fo.sgd_mom_step(
        ks[0], g, ks[1], vec, momentum=0.9), w.device)
    graph.capture()                     # its warm-up: the step at lr 1e-3
    fo.sgd_mom_step_plain(ps[0], g, ps[1], vec.clone(), momentum=0.9)
    for lr in (0.5, 0.25, 0.125):
        vec[0] = lr
        graph.replay()
        fo.sgd_mom_step_plain(ps[0], g, ps[1], vec.clone(), momentum=0.9)
    errs = [compare(torch, a, b, 1e-6, 1e-7) for a, b in zip(ks, ps)]
    log(f'[kernels] sgd_mom captured once and replayed at lr 0.5, 0.25, '
        f'0.125 written into its device vector: weight and momentum against '
        f'the plain version at each lr, max |diff| '
        f'{[float(f"{e:.3g}") for e, _ in errs]} (rtol 1e-6, atol 1e-7)')
    if not all(ok for _, ok in errs):
        fail('kernels: a replayed optimizer update did not read its new '
             'learning rate')
    graph.release()


def _int8_cases(torch, dev, rows):
    """The int8 product against its plain version, bit-equal. The first
    case is the main path's: a decode step's gate or up projection (M = 4
    rows, K = 4096, N = 14336, bf16 out, no bias). Then M in {4, 32, 512}
    over the projections' and the LM head's (N, K), with fp32 or bf16 out
    and with or without bias in turn, a ragged shape, and one with x and w
    off 16-byte alignment and K not a multiple of 16 (the byte loads). The
    library call is ``torch._int_mm`` with the epilogue as PyTorch ops,
    where cuBLASLt takes the shape (M > 16, K and N multiples of 8)."""
    from mxnet_tpu_torch.ops.kernels import int8_matmul as im
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32

    def codes(shape, offset):
        n = math.prod(shape)
        buf = torch.randint(-127, 128, (n + offset,), generator=gen,
                            device=dev, dtype=torch.int8)
        return buf[offset:].view(shape)

    cases = [(4, 14336, 4096, bf16, False, 0)]
    turns = [(bf16, False), (f32, True), (bf16, True), (f32, False)]
    for m in (4, 32, 512):
        for n, k in ((4096, 4096), (1024, 4096), (4096, 14336),
                     (128256, 4096)) + (((14336, 4096),) if m > 4 else ()):
            cases.append((m, n, k) + turns[len(cases) % 4] + (0,))
    for m in (1, 16, 17, 64, 65):    # the edges of the plan's tile widths
        cases.append((m, 4096, 4096) + turns[len(cases) % 4] + (0,))
    cases += [(37, 1000, 200, f32, True, 0), (17, 130, 4100, bf16, True, 1)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sm80 = im.plan(1, 1, 16, False, sms)     # the earlier design, forced
    why = ('an exact int32 sum, then the plain version\'s rounded '
           'operations one for one (__int2float_rn, __fmul_rn, __fadd_rn, '
           '__float2bfloat16_rn)')
    for m, n, k, dt, has_bias, offset in cases:
        x, w = codes((m, k), offset), codes((n, k), offset)
        scale = torch.rand(n, generator=gen, device=dev) * 1e-4 + 1e-6
        b = torch.randn(n, generator=gen, device=dev) if has_bias else None
        got = im.int8_matmul(x, w, scale, b, dt)
        want = im.int8_matmul_plain(x, w, scale, b, dt)
        lib = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            def lib(x=x, wt=w.t(), scale=scale, b=b, dt=dt):
                out = torch._int_mm(x, wt).float() * scale
                return (out if b is None else out + b).to(dt)
            try:
                lib()
            except RuntimeError as e:       # the yardstick only
                log(f'[kernels] torch._int_mm refused ({m}, {n}, {k}): '
                    f'{str(e).splitlines()[0]}')
                lib = None
        out_bytes = 2 if dt == bf16 else 4
        nbytes = m * k + n * k + 4 * n * (2 if has_bias else 1) \
            + out_bytes * m * n
        path = im.plan(m, n, k, offset == 0, sms).path
        earlier = None
        if path != 'sm80':
            out_old = torch.empty(m, n, dtype=dt, device=dev)

            def old(x=x, w=w, scale=scale, b=b, out_old=out_old, m=m, n=n,
                    k=k):
                im._launch(x, w, scale, b, out_old, m, n, k, sm80)
            old()
            if not torch.equal(out_old.float(), want.float()):
                fail(f'int8: the sm80 design differs from the plain '
                     f'version at ({m}, {n}, {k})')
            earlier = (old, 'sm80 design, this run')
        rows['int8_matmul'].append(_case(
            torch, 'int8_matmul',
            f'M={m} N={n} K={k} {str(dt)[6:]} out'
            f'{" + bias" if has_bias else ""}'
            f'{" (x, w off 16-byte alignment)" if offset else ""}',
            got.float(), want.float(), (0.0, 0.0), why,
            lambda: im.int8_matmul(x, w, scale, b, dt),
            lambda: im.int8_matmul_plain(x, w, scale, b, dt),
            nbytes, 2 * m * n * k, lib, ops_s=INT8_OPS_S, path=path,
            earlier=earlier))
        del x, w, scale, b, got, want, lib, earlier
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _int8_host_cost(torch, dev, codes)


def _int8_host_cost(torch, dev, codes, calls=200, rounds=5):
    """Host microseconds per int8 wrapper call, on the host clock over
    ``calls`` calls launched back to back (each kernel takes less time on
    the card than its launch on the host): the TMA designs' plan, the two
    tensor maps that every such call encodes and the workspace, against
    the sm80 design's launch at the same small shape with x and w off
    alignment. The designs take turns for ``rounds`` rounds and each
    keeps its least time, since the host clock drifts from round to
    round by more than the difference measured."""
    from mxnet_tpu_torch.ops.kernels import int8_matmul as im
    cases = {}
    for what, (m, n, k, offset) in (
            ('tma_splitk, K split 16 ways (4, 1024, 4096)', (4, 1024, 4096, 0)),
            ('tma_splitk, unsplit (4, 64, 128)', (4, 64, 128, 0)),
            ('sm80, x and w off alignment (4, 64, 128)', (4, 64, 128, 1))):
        x, w = codes((m, k), offset), codes((n, k), offset)
        cases[what] = (x, w, torch.ones(n, device=dev))
        for _ in range(20):
            im.int8_matmul(*cases[what])
    res = {}
    for _ in range(rounds):
        for what, args in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                im.int8_matmul(*args)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            res[what] = min(res.get(what, math.inf), (t1 - t0) / calls * 1e6)
    log(f'[kernels] int8_matmul host us per call, launched back to back '
        f'(least of {rounds} rounds of {calls}): ' +
        ', '.join(f'{k} {v:.2f}' for k, v in res.items()))


def _gradient_checks(torch, randn):
    """The norm and flash gradients through their ``autograd.Function``s
    (the kernel forward, the reference's backward) against autograd
    through the plain versions, at a training step's shapes. True when
    every output and gradient agrees."""
    from mxnet_tpu_torch.ops.kernels import fused_norms, flash_attention
    tol = (1e-4, 1e-4)

    def run(fn, args, ct):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        out = fn(*leaves)
        out.backward(ct)
        return (out.detach(),) + tuple(x.grad for x in leaves)

    n, d = TRAIN_TOKENS, 4096
    x, gamma, beta = randn(n, d, scale=2.0) + 0.3, randn(d) + 1.0, randn(d)
    ct = randn(n, d)
    cases = [
        (f'fused_norm rms ({n}, {d})', (x, gamma), ct,
         lambda x_, g_: fused_norms.FusedNormFunction.apply(
             x_, g_, None, 1e-5, True),
         lambda x_, g_: fused_norms.fused_norm_plain(x_, g_, None, 1e-5,
                                                     True)),
        (f'fused_norm layer ({n}, {d})', (x, gamma, beta), ct,
         lambda x_, g_, b_: fused_norms.FusedNormFunction.apply(
             x_, g_, b_, 1e-5, False),
         lambda x_, g_, b_: fused_norms.fused_norm_plain(x_, g_, b_, 1e-5,
                                                         False))]
    bh, t, dh = 32, TRAIN_TOKENS, 128
    qkv = [randn(bh, t, dh) for _ in range(3)]
    cases.append((
        f'flash_attention BH={bh} T=S={t} d={dh} causal', qkv,
        randn(bh, t, dh),
        lambda q, k, v: flash_attention.FlashAttentionFunction.apply(
            q, k, v, dh ** -0.5, True),
        lambda q, k, v: flash_attention.flash_attention_plain(
            q, k, v, dh ** -0.5, True)))
    def step_ms(fn, args, ct):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        return eager_ms(torch, lambda: fn(*leaves).backward(ct))

    ok_all = True
    for what, args, ct, fn, plain in cases:
        err, ok = compare(torch, run(fn, args, ct), run(plain, args, ct),
                          *tol)
        ok_all &= ok
        log(f'[kernels] gradient of {what} through its Function: output '
            f'and input gradients max_abs_err {err:.3e} against autograd '
            f'through the plain version (rtol {tol[0]:g}, atol {tol[1]:g}: '
            f'fp32, the backward sums in another order) -> '
            f'{"ok" if ok else "MISMATCH"}; forward + backward '
            f'{step_ms(fn, args, ct):.3f} ms, through the plain version '
            f'{step_ms(plain, args, ct):.3f} ms (launched from Python)')
    del cases, qkv, x, gamma, beta, ct
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ok_all


def _sync(torch, dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _device(net):
    return net._device()


def _t(x):
    """The tensor of an NDArray (the Gluon Llama's logits), or ``x``."""
    return x._data if hasattr(x, '_data') else x


def build_llama(name, seed, where='cuda', serve=True, **kw):
    """``get_llama(name, **kw)`` initialized by ``LlamaInit(seed)`` on
    ``where`` (inside a ``tp`` mesh: this rank's shards of the same
    values). ``serve`` sets ``grad_req='null'`` first, as an MXNet user does
    for inference, so that no parameter holds a gradient buffer."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.llama import LlamaInit, get_llama
    net = get_llama(name, **kw)
    if serve:
        net.collect_params().setattr('grad_req', 'null')
    net.initialize(LlamaInit(seed),
                   ctx=mx.cpu() if where == 'cpu' else mx.gpu(0))
    return net


def copy_llama(net, where):
    """A Llama of ``net``'s configuration on ``where`` holding its weights:
    the float parameters by name, each int8 layer by its quantized state
    (``load_jax_quantized``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.llama import LlamaForCausalLM, \
        from_jax_params
    from mxnet_tpu_torch.quantization import QuantizedDense, _gluon_walk, \
        load_jax_quantized
    q = {path: m for _, _, path, m in _gluon_walk(net)
         if isinstance(m, QuantizedDense)}
    state = {path: dict(qweight=m.qweight.data().asnumpy(),
                        w_scale=m._w_scale.cpu().numpy(),
                        collected_range=m.collected_range, bias=None)
             for path, m in q.items()}
    skip = tuple(f'{path}.' for path in q)
    floats = {n: p.data().asnumpy() for n, p in net.collect_params().items()
              if not n.startswith(skip)}
    out = LlamaForCausalLM(net.cfg)
    out.initialize(initializer.Zero(),
                   ctx=mx.cpu() if str(where) == 'cpu' else mx.gpu(0))
    if not q:
        return from_jax_params(out, floats)
    act = str(next(iter(q.values()))._act_dtype).split('.')[-1]
    return load_jax_quantized(out, state, floats, activation_dtype=act)


def param_bytes(net, dtypes=None):
    """Bytes of ``net``'s parameter leaves here (this rank's shards), of
    the given dtypes only where named."""
    out = 0
    for p in net.collect_params().values():
        t = p._var
        if dtypes is None or str(t.dtype).split('.')[-1] in dtypes:
            out += t.numel() * t.element_size()
    return out


def _want(**counts):
    """Every kernel's expected launches: 0 unless named."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(counts)
    return want


def phase_forward(torch, net, seed, length=512, int8_layers=0, tag='forward'):
    """One ``(1, length)`` forward; returns its logits on the CPU. A net
    with ``int8_layers`` quantized layers launches the int8 kernel once
    for each."""
    from mxnet_tpu_torch.ops import kernels
    cfg, dev = net.cfg, _device(net)
    before = kernels.launch_counts()
    toks = torch.randint(0, cfg.vocab_size, (1, length),
                         generator=torch.Generator().manual_seed(seed))
    _sync(torch, dev)
    t0 = time.perf_counter()
    logits = _t(net(toks.to(dev)))
    _sync(torch, dev)
    dt = time.perf_counter() - t0
    after = kernels.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    log(f'[{tag}] layers={cfg.num_layers} units={cfg.units} '
        f'(1, {length}) forward {dt * 1e3:.1f} ms, logits '
        f'{tuple(logits.shape)} {logits.dtype}, launches {delta}')
    if tuple(logits.shape) != (1, length, cfg.vocab_size):
        fail(f'{tag}: logits shape {tuple(logits.shape)}')
    if not bool(torch.isfinite(logits).all()):
        fail(f'{tag}: logits are not finite')
    want = _want(fused_norm=2 * cfg.num_layers + 1,
                 flash_attention=cfg.num_layers, int8_matmul=int8_layers)
    if dev.type == 'cuda' and delta != want:
        fail(f'{tag}: launches {delta}, want {want}')
    return logits.float().cpu()


def _prompts(torch, vocab, seed):
    """Six seeded prompts of 17 to 1500 tokens. The first and the fifth
    share a 64-token prefix (two full prefill chunks); the fifth is
    admitted only once a slot frees, after the first has published its
    chunks, so it is served from the prefix cache."""
    g = torch.Generator().manual_seed(seed)

    def rand(n):
        return torch.randint(1, vocab, (n,), generator=g).tolist()
    shared = rand(64)
    return [shared + rand(33), rand(1500), rand(17), rand(700),
            shared + rand(100), rand(300)]


def phase_serve(torch, net, seed, int8_layers=0, tag='serve'):
    """The six prompts through ``DecodeServer``, whose warm-up captures the
    prefill chunk and the decode step as CUDA graphs that every later
    call replays; a net with ``int8_layers`` quantized layers launches the
    int8 kernel once for each in every decode step and prefill chunk.
    The counts take in the warm-up's two eager calls (one chunk, one
    step) and every replay; the server must have captured twice and
    never again, and its audit must find the pool written in place and
    no allocation in a replayed step."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.serve import DecodeServer

    prompts = _prompts(torch, net.cfg.vocab_size, seed)
    n_new = 32
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    ds = DecodeServer(net, slots=4, max_length=2048, page_size=16,
                      prefill_chunk=32)
    try:
        log(f'[{tag}] server built in {time.perf_counter() - t0:.2f} s, '
            f'{ds.warmup_compiles} graphs captured at warm-up')
        t0 = time.perf_counter()
        futs = [ds.submit(p, n_new) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        stats = ds.stats()
        stats['wall_s'] = wall
        after = kernels.launch_counts()
        audit = ds.audit_donation()
    finally:
        ds.close()
    delta = {k: after[k] - before[k] for k in after}
    steps, chunks = stats['steps'], stats['prefill_chunks']
    gen = sum(len(o) for o in outs)
    log(f'[{tag}] {len(prompts)} requests, prompt lengths '
        f'{[len(p) for p in prompts]}, {gen} tokens in {wall:.2f} s '
        f'({gen / wall:.1f} tok/s), decode steps {steps}, prefill chunks '
        f'{chunks}, prefix_hit {stats["prefix_hit"]}, launches {delta}')
    beside_earlier(tag, 'tok/s', gen / wall, 'tok/s')
    log(f'[{tag}] ttft_ms p50 {stats["ttft_ms"][50]:.1f} p95 '
        f'{stats["ttft_ms"][95]:.1f}; intertoken_ms p50 '
        f'{stats["intertoken_ms"][50]:.1f} p95 '
        f'{stats["intertoken_ms"][95]:.1f}')
    server_checks(stats, audit, net, tag)
    if [len(o) for o in outs] != [n_new] * len(prompts):
        fail(f'{tag}: token counts {[len(o) for o in outs]}')
    if stats['prefix_hit'] < 1:
        fail(f'{tag}: prefix_hit {stats["prefix_hit"]}')
    L = net.cfg.num_layers
    calls = steps + chunks + 2      # + the warm-up's eager chunk and step
    want = _want(fused_norm=(2 * L + 1) * calls,
                 paged_attention_decode=L * (steps + 1),
                 int8_matmul=int8_layers * calls)
    if _device(net).type == 'cuda' and delta != want:
        fail(f'{tag}: launches {delta}, want {want}')
    return prompts, outs, stats


def server_checks(stats, audit, net, tag):
    """Log a served run's captures and its pool audit; fail unless a server
    on the card captured its two graphs and never again (none on the CPU)
    and the audit is clean: every pool tensor written in place, and no
    allocation in a replayed step on the card."""
    cuda = _device(net).type == 'cuda'
    log(f'[{tag}] compile_count {stats["compile_count"]} recompiles '
        f'{stats["recompiles"]}; audit_donation: {audit.summary()}, '
        f'{audit.stats}')
    if stats['compile_count'] != (2 if cuda else 0) or stats['recompiles']:
        fail(f'{tag}: compile_count {stats["compile_count"]}, recompiles '
             f'{stats["recompiles"]}')
    if not audit.ok or audit.stats['aliased_args'] != \
            2 * net.cfg.num_layers or \
            audit.stats['allocations_per_step'] != (0 if cuda else None):
        fail(f'{tag}: audit_donation {audit}: {audit.findings}')


def eager_steps(torch, net, prompt, n_new, slots=4, max_length=2048,
                psz=16, chunk=32):
    """Greedy tokens of ``prompt`` from eager ``net(...)`` calls at the
    shapes ``serve_one``'s server gives its graphs: ``(1, chunk)``
    prefill chunks through a block-table row of ``max_length / psz``
    pages at Python-int offsets, then decode steps over ``slots`` rows,
    the sequence in row 0 and the others idle on the garbage page."""
    dev = _device(net)
    mp = max_length // psz
    pool = net.init_paged_pool(slots * mp + 1, psz)
    row = torch.arange(1, mp + 1, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        for start in range(0, len(prompt), chunk):
            real = min(chunk, len(prompt) - start)
            toks = prompt[start:start + real] + [0] * (chunk - real)
            logits, _ = net(torch.tensor([toks], device=dev), caches=pool,
                            offset=start, pages=row)
        out = [int(_t(logits)[0, real - 1].float().argmax())]
        bt = torch.zeros(slots, mp, dtype=torch.int32, device=dev)
        bt[0] = row[0]
        while len(out) < n_new:
            toks = torch.zeros(slots, 1, dtype=torch.long, device=dev)
            toks[0, 0] = out[-1]
            offs = torch.zeros(slots, dtype=torch.int32, device=dev)
            offs[0] = len(prompt) + len(out) - 1
            logits, _ = net(toks, caches=pool, offset=offs, pages=bt)
            out.append(int(_t(logits)[0, -1].float().argmax()))
    del pool
    return out


def graph_checks(torch, net, prompt, served, tag='serve'):
    """The graphs against eager calls on one prompt: a server stepped by
    hand (its graphs) and eager steps at the same shapes must pick the
    same greedy tokens, and ``generate()`` replaying its graph the same
    tokens as its eager loop; both timed."""
    n = len(served)
    t0 = time.perf_counter()
    alone = serve_one(torch, net, prompt, n, tag)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = eager_steps(torch, net, prompt, n)
    t_eager = time.perf_counter() - t0
    same = 'the same' if served == eager else 'otherwise'
    log(f'[{tag}] graphed server alone ({t_graph:.2f} s with its warm-up) '
        f'and eager steps ({t_eager:.2f} s) on a {len(prompt)}-token '
        f'prompt: tokens {"equal" if alone == eager else "DIFFER"}; the '
        f'six-request run served it {same}')
    if alone != eager:
        fail(f'{tag}: the graphed server and eager steps part: {alone} '
             f'against {eager}')
    times, toks = {}, {}
    for how, graph in (('eager', False), ('graphed', True),
                       ('graphed', True)):
        caps = net.graph_captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.generate([prompt], max_new_tokens=n, graph=graph)
        toks[how] = out[0, len(prompt):].tolist()
        times[how + (' with capture' if net.graph_captures > caps
                     else '')] = time.perf_counter() - t0
    log(f'[{tag}] generate() over {n} new tokens, s: '
        f'{ {k: round(v, 4) for k, v in times.items()} } '
        f'(graphed {n / times["graphed"]:.1f} tok/s, eager '
        f'{n / times["eager"]:.1f} tok/s); tokens '
        f'{"equal" if toks["eager"] == toks["graphed"] else "DIFFER"}')
    if toks['eager'] != toks['graphed']:
        fail(f'{tag}: graphed generate() {toks["graphed"]} against the '
             f'eager loop {toks["eager"]}')


def profile_breakdown(torch, net, slots=4, depth=1024, chunk=32, reps=5,
                      tag='profile'):
    """Host-clock ms of a decode step over ``slots`` rows at ``depth`` and
    of one ``(1, chunk)`` prefill chunk at ``depth`` (``reps`` calls back
    to back, synchronised at the end), and their kernel time by name from
    ``torch.profiler``, one session a call (``profiled_calls``); the busy
    share is kernel time over host time. Each
    call is timed eager and then replayed from a CUDA graph (captured as
    the server captures it, the chunk's offset a 0-dim tensor), side by
    side. A decode step must show one paged-decode kernel event a layer
    (the splits merge inside the launch), a prefill chunk none."""
    from mxnet_tpu_torch._graphs import StepGraph
    psz, NP, dev = 16, 128, _device(net)
    pool = net.init_paged_pool(slots * NP + 1, psz)
    pages = (torch.arange(slots * NP, dtype=torch.int32) + 1).reshape(
        slots, NP).to(dev)
    toks = torch.ones(slots, 1, dtype=torch.long, device=dev)
    off = torch.full((slots,), depth, dtype=torch.int32, device=dev)
    ctoks = torch.ones(1, chunk, dtype=torch.long, device=dev)
    coff = torch.tensor(depth, dtype=torch.int32, device=dev)
    def step():
        return net(toks, caches=pool, offset=off, pages=pages)
    calls = {   # (eager call, the call a graph captures)
        f'decode step ({slots} slots at depth {depth})': (step, step),
        f'prefill chunk (1, {chunk}) at {depth}': (
            lambda: net(ctoks, caches=pool, offset=depth, pages=pages[:1]),
            lambda: net(ctoks, caches=pool, offset=coff, pages=pages[:1])),
    }
    with torch.no_grad():
        for what, (fn, captured) in calls.items():
            graph = StepGraph(captured, dev)
            graph.capture()
            for how, call in (('eager', fn), ('graphed', graph.replay)):
                call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / reps
                prof = profiled_calls(torch, call, reps,
                                      f'{tag} {how} {what}')
                kernel_breakdown(tag, f'{how} {what}', prof, wall, reps)
                norm_breakdown(tag, f'{how} {what}', prof, reps)
                paged = sum(e.count for e in prof.key_averages()
                            if 'paged_decode_kernel' in e.key)
                want = net.cfg.num_layers * reps if 'decode' in what else 0
                log(f'[{tag}] {how} {what}: {paged // reps} paged-decode '
                    f'kernel events a call (want {want // reps})')
                if paged != want:
                    fail(f'{tag}: {paged} paged-decode kernel events over '
                         f'{reps} {how} calls of the {what}, want {want}')
            graph.release()
    del pool


def profiled():
    """A ``torch.profiler`` context over the host and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class _Merged:
    """The key averages of several ``torch.profiler`` sessions, summed by
    kernel name, with the fields the breakdowns read."""

    def __init__(self, profs):
        by = {}
        for prof in profs:
            for e in prof.key_averages():
                m = by.setdefault((e.key, e.device_type), _Event(
                    e.key, e.device_type))
                m.count += e.count
                m.self_device_time_total += e.self_device_time_total
        self._events = list(by.values())
        self.profs = profs

    def key_averages(self):
        return self._events


class _Event:
    def __init__(self, key, device_type):
        self.key, self.device_type = key, device_type
        self.count, self.self_device_time_total = 0, 0.0


def profiled_calls(torch, call, reps, what):
    """``reps`` calls of ``call()`` (``what``), each in a checked profiler
    session of its own (:func:`profile_checked`), merged. One session over
    all of them once lost 2 of 160 paged-decode events of an eager int8
    decode step; one a call lost events too (ROADMAP C5), hence the
    check."""
    def synced():
        call()
        torch.cuda.synchronize()
    return _Merged([profile_checked(torch, what, synced)[0]
                    for _ in range(reps)])


#: how many times a profiled call runs before a profile that lost kernel
#: events fails its phase (ROADMAP C5)
PROFILE_TRIES = 3
#: ``CHIP_SMOKE_C5_PROBE=1``: the symbol phase's bf16 predict is profiled
#: once with no warm-up kernels before its checked sessions, and whether
#: that session lost events is logged (``[c5]``; ROADMAP C5)
C5_PROBE = os.environ.get('CHIP_SMOKE_C5_PROBE') == '1'
#: every profiled session of this run: (what, try, {kernel: (events,
#: launches)} where the two differ; empty when the profile is whole)
PROFILES = []
#: a profiler event's kernel symbol -> the port kernel it is a launch of
#: (flash_fwd_kernel is both forms of B2/B3, told apart by its Stats
#: template argument; rtc launches a user's kernel, whose name the port
#: does not know, and no profiled call launches one)
KERNEL_SYMBOLS = {'fused_norm_kernel': 'fused_norm',
                  'fused_norm_regs_kernel': 'fused_norm',
                  'fused_norm_cluster_kernel': 'fused_norm',
                  'paged_decode_kernel': 'paged_attention_decode',
                  'adam_kernel': 'adam', 'sgd_mom_kernel': 'sgd_mom',
                  'int8_matmul_kernel': 'int8_matmul',
                  'int8_wgmma_kernel': 'int8_matmul',
                  'flash_fwd_kernel': 'flash_attention'}


def _kernel_of(key):
    """The port kernel a profiler event named ``key`` launched, or None:
    ``void (anonymous namespace)::flash_fwd_kernel<float, 64, true>(...)``
    is B3 (the stats form), with ``false`` B2."""
    name = key.replace('(anonymous namespace)::', '')
    name = name[5:] if name.startswith('void ') else name
    base = name.split('<', 1)[0].split('(', 1)[0].split('::')[-1].strip()
    kernel = KERNEL_SYMBOLS.get(base)
    if kernel == 'flash_attention' and '<' in name:
        args = name.split('<', 1)[1].split('>', 1)[0].split(',')
        if len(args) > 2 and args[2].strip() in ('true', '(bool)1', '1'):
            return 'flash_attention_stats'
    return kernel


def kernel_events(prof):
    """``{port kernel: kernel events}`` of a profiler session."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        kernel = _kernel_of(e.key) if e.device_type == DeviceType.CUDA \
            else None
        if kernel is not None:
            out[kernel] = out.get(kernel, 0) + e.count
    return out


def profile_once(torch, what, call):
    """``call()`` (which ends with a sync of the card) in a
    ``torch.profiler`` session that opens and closes on an idle card.
    Returns the profile, what ``call`` returned, its host ms, the launch
    counters' change over the session, and ``{kernel: (events,
    launches)}`` for every port kernel whose events differ from its
    launches (empty when the profile is whole), which is recorded in
    :data:`PROFILES`."""
    from mxnet_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with profiled() as prof:
        time.sleep(0.005)
        t0 = time.perf_counter()
        out = call()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        time.sleep(0.005)
    launched = _counts_since(kernels, before)
    events = kernel_events(prof)
    short = {k: (events.get(k, 0), launched.get(k, 0))
             for k in sorted(set(events) | set(launched))
             if k != 'rtc' and events.get(k, 0) != launched.get(k, 0)}
    PROFILES.append((what, sum(1 for p in PROFILES if p[0] == what) + 1,
                     short))
    if short:
        log(f'[profile] {what}: the session lost kernel events: '
            + ', '.join(f'{k} {e} events for {n} launches'
                        for k, (e, n) in short.items()))
    return prof, out, ms, launched, short


def profile_checked(torch, what, call, rewind=None, tries=PROFILE_TRIES):
    """:func:`profile_once` until a session's kernel events equal the
    launch counters' change for every port kernel, at most ``tries``
    times; ``rewind()`` (when given) restores the state ``call`` changes
    before it runs again. Fails the phase, naming the kernel and both
    counts, when every try lost events: a short profile never reaches a
    breakdown. Returns the whole session's profile, what ``call``
    returned, its host ms and the launches."""
    for n in range(1, tries + 1):
        prof, out, ms, launched, short = profile_once(torch, what, call)
        if not short:
            return prof, out, ms, launched
        if n < tries and rewind is not None:
            rewind()
    fail(f'{what}: all {tries} profiler sessions lost kernel events; the '
         f'last: ' + ', '.join(f'{k} {e} events for {n_} launches'
                               for k, (e, n_) in short.items()))


class Rewind:
    """The state a training step changes, copied aside, so that a step
    whose profile lost events can run again from the same place: every
    tensor of the Trainer's parameters (running statistics included) and
    of its slots, written back in place (a captured graph reads them at
    their addresses), and the optimizer's update counts. The Trainer's
    device ``t`` vector then holds the counts the step runs at again, so
    it uploads nothing."""

    def __init__(self, torch, trainer):
        from mxnet_tpu_torch.gluon.trainer import _datas, _flat_state
        self.torch = torch
        self.tensors = [t.detach() for p in trainer._params
                        for t in _datas(p)]
        self.tensors += [t for st in trainer._states.values()
                         for t in _flat_state(st)]
        self.saved = [t.clone() for t in self.tensors]
        self.opt = trainer._optimizer
        self.counts = (dict(self.opt._index_update_count),
                       self.opt.num_update)

    def __call__(self):
        with self.torch.no_grad():
            for t, s in zip(self.tensors, self.saved):
                t.copy_(s)
        self.opt._index_update_count = dict(self.counts[0])
        self.opt.num_update = self.counts[1]


def profile_summary():
    """Log every profiled session of the run: how many, and which lost
    kernel events (ROADMAP C5)."""
    lost = [(w, n, s) for w, n, s in PROFILES if s]
    log(f'[profile] {len(PROFILES)} profiler sessions, {len(lost)} lost '
        f'kernel events' + ''.join(
            f'; {w} (try {n}): ' + ', '.join(
                f'{k} {e} events for {c} launches'
                for k, (e, c) in s.items()) for w, n, s in lost))


#: the earlier tree's figures (PERF.md §5, on an H100 80GB HBM3 at
#: 700.00 W) that the Llama phases print theirs beside: host ms of a
#: profiled call, and tok/s of a serving run
EARLIER = {
    ('profile', 'eager decode step (4 slots at depth 1024)'): 33.35,
    ('profile', 'graphed decode step (4 slots at depth 1024)'): 15.63,
    ('profile', 'eager prefill chunk (1, 32) at 1024'): 65.58,
    ('profile', 'graphed prefill chunk (1, 32) at 1024'): 31.43,
    ('int8', 'eager decode step (4 slots at depth 1024)'): 52.52,
    ('int8', 'graphed decode step (4 slots at depth 1024)'): 9.42,
    ('int8', 'eager prefill chunk (1, 32) at 1024'): 92.44,
    ('int8', 'graphed prefill chunk (1, 32) at 1024'): 15.59,
    ('train', 'adam step 3 (profiled)'): 401.45,
    ('bf16', 'llama3_8b fp32 forward'): 652.20,
    ('bf16', 'llama3_8b bf16 forward'): 86.56,
    ('serve', 'tok/s'): 42.3, ('int8', 'tok/s'): 75.5}


def beside_earlier(tag, what, value, unit='host ms'):
    """Log ``value`` beside the earlier tree's figure for it, if any."""
    old = EARLIER.get((tag, what))
    if old is not None:
        log(f'[{tag}] {what}: {value:.2f} {unit} in this tree, {old:.2f} in '
            f'PERF.md §5 ({value / old:.3f}x)')


def kernel_breakdown(tag, what, prof, wall_ms, reps=1, top=8):
    """Log the kernel time of a ``torch.profiler`` run of ``reps`` calls
    by name, against ``wall_ms``, the host-clock ms of one call; returns
    the kernel ms per call. Kernel events only: a CPU op's device time
    repeats its kernels'."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / reps
    log(f'[{tag}] {what}: {wall_ms:.2f} ms on the host clock, '
        f'{busy:.2f} ms of kernel time ({100 * busy / wall_ms:.0f}% '
        f'busy), {sum(e.count for e in ev) // reps} kernels; '
        f'card {smi_line()}')
    beside_earlier(tag, what, wall_ms)
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / reps
        log(f'[{tag}]   {ms:8.3f} ms {100 * ms / busy:5.1f}% '
            f'x{e.count // reps:<4d} {e.key[:90]}')
    return busy


def norm_breakdown(tag, what, prof, reps):
    """Log the fused norm's (B1's) kernel time a call in a
    ``torch.profiler`` run of ``reps`` calls, by kernel: its weights at
    the L2 state the call leaves them in."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and 'fused_norm' in e.key]
    ms = sum(e.self_device_time_total for e in ev) / 1e3 / reps
    n = sum(e.count for e in ev) // reps
    by = ', '.join(f'{e.key.split("(float")[0].split("::")[-1]} '
                   f'x{e.count // reps} '
                   f'{e.self_device_time_total / 1e3 / reps:.4f}'
                   for e in ev)
    log(f'[{tag}] {what}: B1 (fused_norm) {ms:.4f} ms over {n} launches '
        f'a call ({1e3 * ms / max(n, 1):.2f} us each): {by}')


def teacher_forced(torch, net, prompt, out, tag='serve', check=True):
    """Full-sequence forward over prompt + generated tokens (the flash
    path); its greedy picks must equal the server's wherever the top-2
    margin exceeds 1e-2. With ``check`` False the agreement is only
    logged."""
    seq = torch.tensor([prompt + out[:-1]], device=_device(net))
    logits = _t(net(seq))[0, len(prompt) - 1:].float()
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    pick = logits.argmax(-1).tolist()
    clear = [i for i, m in enumerate(margin) if m > 1e-2]
    bad = [i for i in clear if pick[i] != out[i]]
    log(f'[{tag}] teacher-forced check over {len(out)} tokens: '
        f'{len(clear)} with margin > 1e-2, {len(bad)} disagree; '
        f'{sum(p == o for p, o in zip(pick, out))} of {len(out)} equal'
        + ('' if check else ' (logged only)'))
    if check and bad:
        fail(f'{tag}: teacher-forced argmax differs at {bad}')


def path_spread(torch, net, seq):
    """The largest |difference| between the logits of one sequence through
    the full forward (flash attention) and through a paged cache as one
    prefill chunk (the server's gather attention)."""
    dev, psz = _device(net), 16
    n_pages = -(-len(seq) // psz)
    pool = net.init_paged_pool(n_pages + 1, psz)
    pages = torch.arange(1, n_pages + 1, dtype=torch.int32,
                         device=dev)[None]
    toks = torch.tensor([seq], device=dev)
    full = _t(net(toks)).float()
    chunk, _ = net(toks, caches=pool, offset=0, pages=pages)
    return float((full - _t(chunk).float()).abs().max())


@contextlib.contextmanager
def plain_int8(net):
    """Every int8 layer through the product's plain version (its sums in
    float64 on the card), so that a run can be held against the same run
    through the kernel. ``net``'s ``generate()`` graphs, which captured
    one product or the other, are dropped on the way in and out."""
    from mxnet_tpu_torch.ops import quantization_ops
    from mxnet_tpu_torch.ops.kernels import int8_matmul as im
    net.release_graphs()
    quantization_ops.int8_matmul = im.int8_matmul_plain
    try:
        yield
    finally:
        quantization_ops.int8_matmul = im.int8_matmul
        net.release_graphs()


def serve_one(torch, net, prompt, n_new, tag='serve'):
    """One prompt through a ``DecodeServer`` stepped by hand; its captures
    and audit held by ``server_checks``."""
    from mxnet_tpu_torch.serve import DecodeServer
    ds = DecodeServer(net, slots=4, max_length=2048, page_size=16,
                      prefill_chunk=32, start=False)
    try:
        fut = ds.submit(prompt, n_new)
        while not fut.done():
            ds.step_once()
        server_checks(ds.stats(), ds.audit_donation(), net, tag)
        return fut.result()
    finally:
        ds.close()


def phase_int8(torch, net, seed, float_logits=None, float_outs=None):
    """Quantize ``net`` in place (naive calibration on one seeded (1, 512)
    batch, bf16 activations) and drive the int8 net: the forward, the
    server over the six prompts, and ``generate()`` on one of them, each
    launch counted. The float net's logits and tokens, where given, are
    compared in the log only. Returns what :func:`int8_checks` holds."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.quantization import QuantizedDense, _gluon_walk, \
        quantize_net
    cfg = net.cfg
    L = cfg.num_layers
    n_dense = 7 * L + (0 if cfg.tie_word_embeddings else 1)
    calib = torch.randint(0, cfg.vocab_size, (1, 512),
                          generator=torch.Generator().manual_seed(seed))
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_net(net, calib_data=[NDArray(calib.to(_device(net)))],
                 calib_mode='naive')
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = kernels.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    torch.cuda.empty_cache()
    layers = [m for _, _, _, m in _gluon_walk(net)
              if isinstance(m, QuantizedDense)]
    int8_bytes = param_bytes(net, ('int8',))
    float_bytes = param_bytes(net) - int8_bytes
    log(f'[int8] quantize_net (naive, one (1, 512) batch) in {dt:.1f} s: '
        f'{len(layers)} QuantizedDense layers, {int8_bytes / 1e9:.3f} GB of '
        f'int8 weights, {float_bytes / 1e9:.3f} GB of float parameters '
        f'left, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; '
        f'calibration launches {delta}')
    if len(layers) != n_dense:
        fail(f'int8: {len(layers)} QuantizedDense layers, want {n_dense}')
    if delta != _want(fused_norm=2 * L + 1, flash_attention=L):
        fail(f'int8: the calibration forward launched {delta}')
    logits = phase_forward(torch, net, SEED + 1, int8_layers=n_dense,
                           tag='int8')
    if float_logits is not None:
        agree = (logits.argmax(-1) == float_logits.argmax(-1)).float().mean()
        log(f'[int8] against the float net on the same tokens: max |logit '
            f'difference| {float((logits - float_logits).abs().max()):.4f} '
            f'(max |logit| {float(float_logits.abs().max()):.4f}), the same '
            f'top-1 at {100 * float(agree):.1f} % of positions')
    prompts, outs, _ = phase_serve(torch, net, SEED + 2, int8_layers=n_dense,
                                   tag='int8')
    if float_outs is not None:
        same = sum(a == b for o, f in zip(outs, float_outs)
                   for a, b in zip(o, f))
        log(f'[int8] served tokens equal to the float net\'s: {same} of '
            f'{sum(len(o) for o in outs)}')

    prompt, n = prompts[2], len(outs[2])
    before = kernels.launch_counts()
    caps = net.graph_captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = net.generate([prompt], max_new_tokens=n)[0, len(prompt):].tolist()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = kernels.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    caps = net.graph_captures - caps
    log(f'[int8] generate() greedy over the dense cache, {len(prompt)}-token '
        f'prompt, {n} new tokens in {dt:.2f} s ({n / dt:.1f} tok/s, '
        f'{caps} decode graph captured), launches {delta}')
    calls = n + caps        # + the warm-up step of a capture
    if delta != _want(fused_norm=(2 * L + 1) * calls,
                      int8_matmul=n_dense * calls):
        fail(f'int8: generate() launches {delta}')
    return dict(logits=logits, prompts=prompts, outs=outs, gen=gen)


def int8_checks(torch, net, logits, prompts, outs, gen):
    """Hold the int8 net's runs through the kernel to the same runs with
    every int8 layer through the product's plain version: the (1, 512)
    forward's logits bit-equal, and the same tokens from the server and
    from ``generate()`` on one prompt (the kernel is bit-equal to its
    plain version, and every other op runs as it did). Then log how the
    paths compare with each other, and profile a decode step and a
    prefill chunk.

    The teacher-forced check and ``generate()`` against the server are
    logged, not held: on this random 32-layer int8 net a difference of
    one rounding between two attention paths moves int8 codes, whose
    errors the next layers' norms and projections spread into more
    codes, so the paths part in their logits by as much as quantizing
    moves them from the float net's."""
    prompt, out = prompts[2], outs[2]
    toks = torch.randint(0, net.cfg.vocab_size, (1, 512),
                         generator=torch.Generator().manual_seed(SEED + 1))
    with plain_int8(net), torch.no_grad():
        plain = _t(net(toks.to(_device(net)))).float().cpu()
        plain_served = serve_one(torch, net, prompt, len(out), tag='int8')
        plain_gen = net.generate([prompt], max_new_tokens=len(out))[
            0, len(prompt):].tolist()
    ok = torch.equal(plain, logits)
    log(f'[int8] through the plain int8 product instead of the kernel: the '
        f'(1, 512) forward\'s logits {"bit-equal" if ok else "DIFFER"} '
        f'(max |difference| {float((plain - logits).abs().max()):.3g}); '
        f'served tokens of prompt 3 {"equal" if plain_served == out else "DIFFER"}; '
        f'generate() tokens {"equal" if plain_gen == gen else "DIFFER"}')
    if not ok or plain_served != out or plain_gen != gen:
        fail('int8: the kernel and its plain version drive the net apart')
    part = next((i for i, (a, b) in enumerate(zip(gen, out)) if a != b),
                len(out))
    log(f'[int8] generate() (dense cache) and the server (paged cache) agree '
        f'on the first {part} of {len(out)} tokens (logged only); largest '
        f'logit difference between the flash and the paged path over the '
        f'served sequence {path_spread(torch, net, prompt + out[:-1]):.4g}')
    graph_checks(torch, net, prompt, out, tag='int8')
    teacher_forced(torch, net, prompt, out, tag='int8', check=False)
    profile_breakdown(torch, net, tag='int8')


def int8_parity(torch, seed):
    """A small Llama (head dim 64, GQA 4/2) quantized on the CPU, then
    served on the card (the int8 kernel) and on the CPU (its plain
    version): the greedy tokens must be equal."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.quantization import quantize_net
    from mxnet_tpu_torch.serve import DecodeServer
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 19, 40)]
    calib = torch.randint(0, 512, (2, 24), generator=g)
    cpu_net = build_llama('llama_tiny', seed, 'cpu', **SMALL_LLAMA)
    quantize_net(cpu_net, calib_data=[NDArray(calib)], calib_mode='naive')
    outs, launches = {}, {}
    for where in ('cpu', 'cuda'):
        net = copy_llama(cpu_net, where)
        before = kernels.launch_counts()['int8_matmul']
        ds = DecodeServer(net, slots=2, max_length=64, page_size=4,
                          prefill_chunk=8, start=False)
        futs = [ds.submit(p, 8) for p in prompts]
        while not all(f.done() for f in futs):
            ds.step_once()
        outs[where] = [f.result() for f in futs]
        stats = ds.stats()
        after = kernels.launch_counts()['int8_matmul']
        server_checks(stats, ds.audit_donation(), net, f'int8 {where}')
        ds.close()
        # + the warm-up's eager chunk and step on the card
        calls = stats['steps'] + stats['prefill_chunks'] + 2
        launches[where] = (after - before,
                           15 * calls if where == 'cuda' else 0)
    ok = outs['cuda'] == outs['cpu'] and all(
        a == b for a, b in launches.values())
    log(f'[int8] small quantized Llama (units 256, heads 4/2, dh 64, bf16 '
        f'activations) served on the card {outs["cuda"]}, on the CPU '
        f'{outs["cpu"]}; int8 launches (got, want) {launches} -> '
        f'{"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('int8: the card and the CPU serve the small quantized Llama '
             'apart')


#: the small Llama of the parity checks: head dim 64, GQA 4/2
SMALL_LLAMA = dict(vocab_size=512, units=256, num_layers=2, num_heads=4,
                   num_kv_heads=2, hidden_size=512, max_length=128)


def _grad_faults(torch, params):
    """Names of the parameters whose gradient is not finite, or zero
    everywhere."""
    out = []
    for n, p in params.items():
        g = p.grad()._data
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            out.append(n)
    return out


def phase_train(torch, seed, steps=3):
    """``llama3_8b``'s widths at ``TRAIN_LAYERS`` layers: ``steps`` steps of
    each Trainer of ``TRAIN_OPTS`` in turn, on one seeded batch of
    ``TRAIN_TOKENS`` tokens, as tests/test_llama.py's loop runs them, each
    run from the same seeded weights; the last step of each run goes
    through ``torch.profiler``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer, loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.llama import LlamaInit
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_llama('llama3_8b', seed, serve=False,
                      num_layers=TRAIN_LAYERS)
    L = net.cfg.num_layers
    params = net.collect_params()
    n_par = param_bytes(net) // 4
    torch.cuda.synchronize()
    log(f'[train] llama3_8b widths at {L} layers: {len(params)} '
        f'parameters, {n_par / 1e9:.3f} B fp32, on cuda in '
        f'{time.perf_counter() - t0:.1f} s')
    toks = torch.randint(0, net.cfg.vocab_size, (1, TRAIN_TOKENS + 1),
                         generator=torch.Generator().manual_seed(seed))
    toks = toks.cuda()
    x, y = NDArray(toks[:, :-1]), NDArray(toks[:, 1:])
    loss_fn = gloss.SoftmaxCrossEntropyLoss()
    for run, (opt, kernel, hyper) in enumerate(TRAIN_OPTS):
        if run:
            net.initialize(LlamaInit(seed), ctx=mx.gpu(0),
                           force_reinit=True)
        trainer = Trainer(params, opt, dict(hyper))
        want = dict.fromkeys(KERNELS, 0)
        want.update(fused_norm=2 * L + 1, flash_attention=L)
        want[kernel] = len(params)
        losses, wall = [], []

        def step(check=False):
            with mx.autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            if check:
                bad = _grad_faults(torch, params)
                if bad:
                    fail(f'train: after the first backward these '
                         f'parameters have no finite nonzero gradient: '
                         f'{bad}')
                log(f'[train] after the first backward all '
                    f'{len(params)} parameters have a finite gradient, '
                    f'nonzero somewhere')
            trainer.step(1)
            torch.cuda.synchronize()
            return loss

        for i in range(steps):
            if i == steps - 1:  # the profiled step; a retry is one more
                prof, loss, ms, delta = profile_checked(
                    torch, f'train {opt} step {steps}', step)
                wall.append(ms)
            else:
                before = kernels.launch_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loss = step(check=run == 0 and i == 0)
                wall.append((time.perf_counter() - t1) * 1e3)
                delta = _counts_since(kernels, before)
            losses.append(float(loss.asnumpy()))
            delta = {k: delta.get(k, 0) for k in want}
            if delta != want:
                fail(f'train: {opt} step {i + 1} launches {delta}, want '
                     f'{want}')
        log(f'[train] {opt} {hyper}: losses {losses}; host ms per step '
            f'{[round(w, 2) for w in wall]} (step {steps} profiled); '
            f'{TRAIN_TOKENS / wall[-2] * 1e3:.1f} tokens/s at step '
            f'{steps - 1}; launches per step {want}')
        # the busy share takes the profiled step's own host time, which the
        # profiler lengthens a little, so the share is a lower bound
        kernel_breakdown('train', f'{opt} step {steps} (profiled)', prof,
                         wall[-1], top=12)
        if not all(math.isfinite(v) for v in losses):
            fail(f'train: {opt} losses not finite: {losses}')
        if not losses[-1] < losses[0]:
            fail(f'train: {opt} loss did not fall: {losses}')
        del trainer, loss, prof
    log(f'[train] peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB')
    del net, params, x, y, toks
    torch.cuda.empty_cache()


def train_parity(torch, seed, steps=2):
    """A small Llama (head dim 64, GQA 4/2) trains ``steps`` Adam steps on
    the card, through the kernels, and on the CPU, through the plain
    versions, from the same weights and tokens: the losses must agree at
    rtol 1e-4, and every parameter on the card must get a gradient."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer, loss as gloss
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    cpu_net = build_llama('llama_tiny', seed, 'cpu', serve=False,
                          **SMALL_LLAMA)
    toks = torch.randint(0, 512, (2, 33),
                         generator=torch.Generator().manual_seed(seed))
    losses = {}
    for where in ('cpu', 'cuda'):
        net = copy_llama(cpu_net, where)
        params = net.collect_params()
        trainer = Trainer(params, 'adam', {'learning_rate': 1e-3})
        t = NDArray(toks.to(where))
        losses[where] = []
        for i in range(steps):
            with mx.autograd.record():
                loss = gloss.SoftmaxCrossEntropyLoss()(net(t[:, :-1]),
                                                        t[:, 1:]).mean()
            loss.backward()
            if i == 0 and _grad_faults(torch, params):
                fail(f'train: on {where} these parameters of the small '
                     f'Llama get no gradient: {_grad_faults(torch, params)}')
            trainer.step(1)
            losses[where].append(float(loss.asnumpy()))
    ok = all(math.isclose(a, b, rel_tol=1e-4)
             for a, b in zip(losses['cuda'], losses['cpu']))
    log(f'[train] small Llama (units 256, heads 4/2, dh 64), {steps} Adam '
        f'steps: losses on the card {losses["cuda"]}, on the CPU '
        f'{losses["cpu"]} (rtol 1e-4) -> {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('train: the card and the CPU train the small Llama apart')


# ------------------------------------------------------------- ndarray
#: the imperative program's widths: llama3_8b's (one decoder block with
#: the embedding and the LM head) on the card, llama_tiny's in the CPU test
FRONTEND_WIDTHS = {
    'llama3_8b': dict(vocab=128256, units=4096, heads=32, kv_heads=8,
                      hidden=14336, theta=500000.0, eps=1e-5),
    'llama_tiny': dict(vocab=256, units=64, heads=4, kv_heads=2,
                       hidden=128, theta=10000.0, eps=1e-5)}
#: the ndarray phase: one seeded (1, NDARRAY_TOKENS + 1) batch, and
#: NDARRAY_STEPS steps of each optimizer, each run from the same weights
NDARRAY_TOKENS = 2048
NDARRAY_STEPS = 3
FRONTEND_OPTS = (('adam', {'lr': 1e-5}),
                 ('sgd_mom', {'lr': 0.1, 'momentum': 0.9}))
_L0 = 'model.layers0.'


def frontend_shapes(w):
    """``{parameter: shape}`` of the imperative program, under the port
    Llama's parameter names (a one-block ``LlamaForCausalLM``)."""
    d, dh = w['units'], w['units'] // w['heads']
    return {'model.embed_tokens.weight': (w['vocab'], d),
            _L0 + 'input_layernorm.weight': (d,),
            _L0 + 'self_attn.q_proj.weight': (w['heads'] * dh, d),
            _L0 + 'self_attn.k_proj.weight': (w['kv_heads'] * dh, d),
            _L0 + 'self_attn.v_proj.weight': (w['kv_heads'] * dh, d),
            _L0 + 'self_attn.o_proj.weight': (d, w['heads'] * dh),
            _L0 + 'post_attention_layernorm.weight': (d,),
            _L0 + 'mlp.gate_proj.weight': (w['hidden'], d),
            _L0 + 'mlp.up_proj.weight': (w['hidden'], d),
            _L0 + 'mlp.down_proj.weight': (d, w['hidden']),
            'model.norm.weight': (d,),
            'lm_head.weight': (w['vocab'], d)}


def frontend_loss(mx, p, tokens, w):
    """The imperative program: a one-block Llama's mean next-token loss
    over ``tokens`` ``(B, S + 1)`` int32, written only with ``mx.np`` and
    ``mx.npx`` calls on the NDArrays ``p`` (:func:`frontend_shapes`), for
    ``mx`` either package. RMSNorm, GQA attention through
    ``npx.flash_attention`` with interleaved RoPE from ``mx.np`` ops, a
    SwiGLU MLP, the LM head, ``log_softmax`` and ``pick``."""
    np_, npx = mx.np, mx.npx
    x_ids, y_ids = tokens[:, :-1], tokens[:, 1:]
    B, S = x_ids.shape
    H, KV = w['heads'], w['kv_heads']
    dh = w['units'] // H

    def proj(x, name):
        return npx.fully_connected(x, p[_L0 + name + '.weight'],
                                   no_bias=True, flatten=False)

    inv = 1.0 / (w['theta'] ** (np_.arange(0, dh, 2, dtype='float32') / dh))
    ang = np_.arange(S, dtype='float32')[:, None] * inv[None, :]
    cos, sin = np_.cos(ang)[None, :, None, :], np_.sin(ang)[None, :, None, :]

    def rope(x):
        x1, x2 = x[..., ::2], x[..., 1::2]
        return np_.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         axis=-1).reshape(x.shape)

    h = npx.embedding(x_ids, p['model.embed_tokens.weight'])
    a = npx.rms_norm(h, p[_L0 + 'input_layernorm.weight'], eps=w['eps'])
    q = rope(proj(a, 'self_attn.q_proj').reshape(B, S, H, dh))
    k = rope(proj(a, 'self_attn.k_proj').reshape(B, S, KV, dh))
    v = proj(a, 'self_attn.v_proj').reshape(B, S, KV, dh)
    k, v = np_.repeat(k, H // KV, axis=2), np_.repeat(v, H // KV, axis=2)
    o = npx.flash_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                            v.transpose(0, 2, 1, 3), causal=True)
    h = h + proj(o.transpose(0, 2, 1, 3).reshape(B, S, H * dh),
                 'self_attn.o_proj')
    m = npx.rms_norm(h, p[_L0 + 'post_attention_layernorm.weight'],
                     eps=w['eps'])
    h = h + proj(npx.silu(proj(m, 'mlp.gate_proj')) * proj(m, 'mlp.up_proj'),
                 'mlp.down_proj')
    h = npx.rms_norm(h, p['model.norm.weight'], eps=w['eps'])
    logits = npx.fully_connected(h, p['lm_head.weight'], no_bias=True,
                                 flatten=False)
    return -npx.pick(npx.log_softmax(logits, axis=-1), y_ids,
                     axis=-1).mean()


def frontend_backward(mx, p, tokens, w):
    """Record the program and run ``loss.backward()``; returns the loss
    (the gradients are in ``p[name].grad``)."""
    with mx.autograd.record():
        loss = frontend_loss(mx, p, tokens, w)
    loss.backward()
    return loss


def frontend_update(mx, p, slots, opt, hyper, t):
    """One optimizer step over every parameter through
    ``npx.fused_adam_step`` / ``npx.fused_sgd_mom_step``, which return new
    arrays: ``p`` and ``slots`` are rebound and the new weights marked for
    the next ``backward``."""
    for n in p:
        if opt == 'adam':
            new = mx.npx.fused_adam_step(p[n], p[n].grad, *slots[n], t=t,
                                         **hyper)
        else:
            new = mx.npx.fused_sgd_mom_step(p[n], p[n].grad, *slots[n],
                                            **hyper)
        p[n], slots[n] = new[0], tuple(new[1:])
        p[n].attach_grad()


def frontend_slots(mx, p, opt):
    return {n: tuple(mx.np.zeros(a.shape) for _ in range(
        2 if opt == 'adam' else 1)) for n, a in p.items()}


def module_step(torch, net, tokens, opt, hyper, slots, t):
    """The same step through the port's module path: ``net`` (a one-block
    Gluon ``LlamaForCausalLM``), ``mx.autograd``,
    ``SoftmaxCrossEntropyLoss`` and the in-place tensor functions of
    ``ops/optimizer_ops.py`` on each parameter's leaf and grad buffer;
    returns the loss."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.ops import optimizer_ops as oo
    x, y = NDArray(tokens[:, :-1]), NDArray(tokens[:, 1:])
    with autograd.record():
        loss = gloss.SoftmaxCrossEntropyLoss()(net(x), y).mean()
    loss.backward()
    with torch.no_grad():
        for n, prm in net.collect_params().items():
            w, g = prm._sync(), prm._grad_buffer()
            if opt == 'adam':
                oo.fused_adam_step(w, g, *slots[n], t=t, **hyper)
            else:
                oo.fused_sgd_mom_step(w, g, *slots[n], **hyper)
    return loss._data.detach()


def module_net(torch, w, p, device):
    """A one-block Gluon ``LlamaForCausalLM`` at widths ``w`` on
    ``device`` whose weights are copies of the NDArray payloads ``p``."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.llama import LlamaConfig, \
        LlamaForCausalLM
    from mxnet_tpu_torch.ndarray.ndarray import context_of
    cfg = LlamaConfig(vocab_size=w['vocab'], units=w['units'], num_layers=1,
                      num_heads=w['heads'], num_kv_heads=w['kv_heads'],
                      hidden_size=w['hidden'], rope_theta=w['theta'],
                      rms_norm_eps=w['eps'])
    net = LlamaForCausalLM(cfg)
    net.initialize(initializer.Zero(), ctx=context_of(torch.device(device)))
    load_module(torch, net, p)
    return net


def module_params(net):
    """The module path's weights, by name: each parameter's leaf."""
    return {n: prm._sync() for n, prm in net.collect_params().items()}


def load_module(torch, net, p):
    for n, prm in net.collect_params().items():
        prm.set_data(p[n]._data)


def _take_back(kernels, before, paths_before):
    """Take the launches since ``before`` back off the counters: the
    module path is the ndarray phase's reference, so its window counts the
    imperative program's launches only."""
    after, paths = kernels.launch_counts(), kernels.path_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    by_path = {k: {d: n - paths_before[k].get(d, 0) for d, n in v.items()
                   if n != paths_before[k].get(d, 0)}
               for k, v in paths.items()}
    kernels.add_launch_counts(delta, {k: v for k, v in by_path.items() if v},
                              times=-1)
    return delta


def phase_ndarray(torch, seed):
    """The imperative frontend at ``llama3_8b``'s widths: the program of
    :func:`frontend_loss` (one decoder block with the embedding and the LM
    head) on ``mx.gpu(0)`` over one seeded ``(1, NDARRAY_TOKENS + 1)``
    batch, ``NDARRAY_STEPS`` steps of each optimizer of ``FRONTEND_OPTS``
    from the same seeded weights, in lockstep with the module path
    (:func:`module_step`) from copies of the same weights: every loss and
    every weight after every step bit-equal to it (both paths run the same
    kernels and cuBLAS calls in the same order; a tolerance as wide as one
    Adam update at lr 1e-5 would pass a step that left the weights as they
    were). Each imperative step must launch the norm kernel 3 times, flash
    attention once and its optimizer's kernel once a parameter, and
    nothing else. Then one ``npx.paged_attention_decode`` and one
    ``nd.quantized_dense`` at their decode-step shapes, each against its
    plain version. Returns what :func:`ndarray_costs` times."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels, registry
    w = FRONTEND_WIDTHS['llama3_8b']
    dev = mx.gpu(0).to_torch()  # the default context: NDArrays go there
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    mx.random.seed(seed)
    p0 = {n: mx.np.ones(shape) if len(shape) == 1 else
          mx.np.random.normal(0.0, 0.02, size=shape)
          for n, shape in frontend_shapes(w).items()}
    tokens = mx.np.random.randint(0, w['vocab'],
                                  size=(1, NDARRAY_TOKENS + 1))
    c0, q0 = kernels.launch_counts(), kernels.path_counts()
    net = module_net(torch, w, p0, dev)
    _take_back(kernels, c0, q0)
    toks = tokens._data.long()
    _sync(torch, dev)
    n_par = sum(a.size for a in p0.values())
    log(f'[ndarray] llama3_8b widths, one block with the embedding and the '
        f'LM head: {len(p0)} parameters, {n_par / 1e9:.3f} B fp32, as '
        f'NDArrays on {tokens.context} and copied into the module path, in '
        f'{time.perf_counter() - t0:.1f} s')
    want = dict.fromkeys(KERNELS, 0)
    want.update(fused_norm=3, flash_attention=1)
    host = {}
    for opt, hyper in FRONTEND_OPTS:
        p = dict(p0)
        for a in p.values():
            a.attach_grad()
        slots = frontend_slots(mx, p, opt)
        load_module(torch, net, p0)
        mslots = {n: tuple(torch.zeros_like(q) for _ in slots[n])
                  for n, q in module_params(net).items()}
        step_want = dict(want, **{'adam' if opt == 'adam' else 'sgd_mom':
                                  len(p)})
        rows = []
        for t in range(1, NDARRAY_STEPS + 1):
            before, d0 = kernels.launch_counts(), registry.dispatch_count()
            _sync(torch, dev)
            t1 = time.perf_counter()
            loss = frontend_backward(mx, p, tokens, w)
            frontend_update(mx, p, slots, opt, hyper, t)
            lv = loss.item()
            imp_ms = (time.perf_counter() - t1) * 1e3
            ops = registry.dispatch_count() - d0
            after = kernels.launch_counts()
            got = {k: after[k] - before[k] for k in after}
            if got != step_want:
                fail(f'ndarray: {opt} step {t} launches {got}, want '
                     f'{step_want}')
            del loss
            c1, q1 = kernels.launch_counts(), kernels.path_counts()
            _sync(torch, dev)
            t2 = time.perf_counter()
            mv = float(module_step(torch, net, toks, opt, hyper, mslots, t))
            mod_ms = (time.perf_counter() - t2) * 1e3
            mod = _take_back(kernels, c1, q1)
            if {k: mod.get(k, 0) for k in KERNELS} != step_want:
                fail(f'ndarray: the module path launched {mod}, want '
                     f'{step_want}')
            werr = max(float((p[n]._data.detach() - prm.detach()).abs().max())
                       for n, prm in module_params(net).items())
            ok = lv == mv and werr == 0 and math.isfinite(lv)
            rows.append((t, lv, mv, werr, imp_ms, mod_ms, ops))
            log(f'[ndarray] {opt} step {t}: loss {lv!r} (module path '
                f'{mv!r}), weights max |diff| {werr:.3e} (both bit-equal); host '
                f'ms imperative {imp_ms:.2f}, module path {mod_ms:.2f}; '
                f'{ops} ops dispatched -> {"ok" if ok else "MISMATCH"}')
            if not ok:
                fail(f'ndarray: {opt} step {t} parts from the module path')
        if not rows[-1][1] < rows[0][1]:
            fail(f'ndarray: {opt} loss did not fall: {rows}')
        host[opt] = rows
        del slots, mslots
    log(f'[ndarray] peak memory '
        f'{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB (both '
        f'paths\' weights, gradients and slots at once)')
    g = {n: a.grad for n, a in p.items()}
    _decode_ops(torch, mx, dev)
    return dict(p=p, g=g, net=net, host=host)


def _decode_ops(torch, mx, dev):
    """``npx.paged_attention_decode`` (B4) and ``nd.quantized_dense`` (B7)
    at a decode step's shapes, each against its plain version: paged
    decode within rtol 1e-4 and atol 1e-4 (an online softmax across tiles
    against one pass), the int8 product bit-equal."""
    from mxnet_tpu_torch.ops.kernels import int8_matmul as im
    from mxnet_tpu_torch.ops.kernels import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(11)
    B, H, kv, dh, psz, NP = 4, 32, 8, 128, 16, 128
    q = torch.randn(B, H, dh, generator=gen, device=dev)
    kp, vp = (torch.randn(B * NP + 1, psz, kv, dh, generator=gen, device=dev)
              for _ in range(2))
    pages = (torch.randperm(B * NP, generator=gen, device=dev) + 1).reshape(
        B, NP).to(torch.int32)
    offset = torch.full((B,), 1024, dtype=torch.int32, device=dev)
    got = mx.npx.paged_attention_decode(*[mx.np.array(a) for a in
                                          (q, kp, vp, pages, offset)])
    want = pa.paged_attention_decode_plain(
        q.reshape(B, kv, H // kv, dh), kp, vp, pages, offset,
        dh ** -0.5).reshape(B, H, dh)
    err, ok = compare(torch, got._data, want, 1e-4, 1e-4)
    log(f'[ndarray] npx.paged_attention_decode {tuple(got.shape)} at depth '
        f'1024: max_abs_err {err:.3e} against its plain version (rtol 1e-4, '
        f'atol 1e-4) -> {"ok" if ok else "MISMATCH"}')
    x = torch.randint(-127, 128, (4, 4096), generator=gen, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (14336, 4096), generator=gen, device=dev,
                       dtype=torch.int8)
    scale = torch.rand(14336, generator=gen, device=dev) * 1e-4 + 1e-6
    got8 = mx.nd.quantized_dense(*[mx.np.array(a) for a in (x, wq, scale)],
                                 out_dtype='bfloat16')
    want8 = im.int8_matmul_plain(x, wq, scale, None, torch.bfloat16)
    ok8 = bool(torch.equal(got8._data, want8))
    log(f'[ndarray] nd.quantized_dense (4, 4096) x (14336, 4096) bf16 out: '
        f'bit-equal to its plain version -> {"ok" if ok8 else "MISMATCH"}')
    if not (ok and ok8):
        fail('ndarray: a kernel-backed op parts from its plain version')


def add_us(torch, mx, rounds=5, calls=2000):
    """Host us a call of ``mx.np.add`` of (4, 4) and of ``torch.add`` on
    the same payloads, each the least of ``rounds`` rounds of ``calls``."""
    a, b = mx.np.ones((4, 4)), mx.np.ones((4, 4))
    ta, tb = a._data, b._data

    def per_call_us(fn):
        best = math.inf
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        return best

    for _ in range(100):
        mx.np.add(a, b)
        torch.add(ta, tb)
    return per_call_us(lambda: mx.np.add(a, b)), \
        per_call_us(lambda: torch.add(ta, tb))


def host_cost(other, rounds=31, calls=2000):
    """``--host-cost DIR``: the host us of ``mx.np.add`` of (4, 4) with
    this tree's ``mxnet_tpu_torch`` and with the one of the checkout
    ``DIR``, each loaded in this process under a name of its own (the
    package imports itself only relatively), timed in turns (the order
    reversed every other round), ``rounds`` rounds of ``calls`` each, the
    least of each kept; ``torch.add`` on the same payloads beside them,
    and the op's own function (the same code in both trees) as a control
    of the measurement."""
    import importlib.util
    import torch

    def load(root, name):
        src = Path(root).resolve() / 'mxnet_tpu_torch'
        spec = importlib.util.spec_from_file_location(
            name, src / '__init__.py', submodule_search_locations=[str(src)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    # both under names of their own, loaded alike
    mine = load(ROOT, 'mxnet_tpu_torch_this')
    theirs = load(other, 'mxnet_tpu_torch_other')
    pairs = {}
    for name, mx in (('this tree', mine), (other, theirs)):
        a, b = mx.np.ones((4, 4)), mx.np.ones((4, 4))
        pairs[name] = (lambda a=a, b=b, mx=mx: mx.np.add(a, b))
        # the op's own function, unchanged between the trees: a control
        # for what the measurement itself makes of two loaded packages
        fn = sys.modules[mx.__name__ + '.ops.registry'].get_op('add').fn
        pairs[f'{name}: the op alone'] = (
            lambda a=a._data, b=b._data, fn=fn: fn(a, b))
    ta, tb = torch.ones(4, 4, device='cuda'), torch.ones(4, 4, device='cuda')
    pairs['torch.add'] = lambda: torch.add(ta, tb)
    best = dict.fromkeys(pairs, math.inf)
    for fn in pairs.values():
        for _ in range(200):
            fn()
    order = list(pairs.items())
    for r in range(rounds):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            best[name] = min(best[name],
                             (time.perf_counter() - t0) / calls * 1e6)
    front = best['this tree'] - best[other]
    control = best['this tree: the op alone'] - best[f'{other}: the op alone']
    log(f'[host cost] host us a call, the least of {rounds} rounds of '
        f'{calls} in turns: ' + ', '.join(
            f'{k} {v:.3f}' for k, v in best.items()) +
        f'; this tree against {other}: mx.np.add {front:+.3f} us, the op '
        f'alone {control:+.3f} us, the frontend\'s own '
        f'{front - control:+.3f} us ({smi_line()})')
    return best


def llama_host_cost(other, rounds=7, layers=8):
    """``--llama-host-cost DIR``: the host ms of the Llama's eager calls
    with this tree's package and with the one of the checkout ``DIR``,
    each loaded in this process under a name of its own, at
    ``llama3_8b``'s widths and ``layers`` layers from the same seeded
    weights: a decode step (4 slots at depth 1024) and a prefill chunk
    ((1, 32) at 1024) over the paged pool, the dense-cache prefill that
    ``generate()`` runs eagerly ((1, 512)) and the (1, 512) forward, each
    synchronised, timed in turns (the order reversed every other round),
    the least of ``rounds`` kept. The kernels are the same in both trees,
    so the difference is host time."""
    import importlib.util
    import torch

    def load(root, name):
        src = Path(root).resolve() / 'mxnet_tpu_torch'
        spec = importlib.util.spec_from_file_location(
            name, src / '__init__.py', submodule_search_locations=[str(src)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    full_fp32(torch)
    trees = {'this tree': load(ROOT, 'mxnet_tpu_torch_this'),
             other: load(other, 'mxnet_tpu_torch_other')}
    dev = torch.device('cuda', 0)
    slots, psz, NP, depth = 4, 16, 128, 1024
    pages = (torch.arange(slots * NP, dtype=torch.int32) + 1).reshape(
        slots, NP).to(dev)
    toks = torch.ones(slots, 1, dtype=torch.long, device=dev)
    off = torch.full((slots,), depth, dtype=torch.int32, device=dev)
    ctoks = torch.ones(1, 32, dtype=torch.long, device=dev)
    ptoks = torch.randint(1, 128256, (1, 512), device=dev,
                          generator=torch.Generator(dev).manual_seed(SEED))
    calls = {}
    for name, mx in trees.items():
        llama = sys.modules[mx.__name__ + '.gluon.model_zoo.llama']
        if hasattr(llama.LlamaForCausalLM, 'collect_params'):
            net = llama.get_llama('llama3_8b', num_layers=layers)
            net.collect_params().setattr('grad_req', 'null')
            net.initialize(llama.LlamaInit(SEED), ctx=mx.gpu(0))
        else:       # the torch.nn Llama of earlier trees
            net = llama.get_llama('llama3_8b', num_layers=layers,
                                  device='cuda', seed=SEED).eval()
        pool = net.init_paged_pool(slots * NP + 1, psz)
        dense = net.init_caches(1, 520)
        calls[name] = {
            f'decode step ({slots} slots at {depth})':
                lambda net=net, pool=pool: net(toks, caches=pool,
                                               offset=off, pages=pages),
            f'prefill chunk (1, 32) at {depth}':
                lambda net=net, pool=pool: net(ctoks, caches=pool,
                                               offset=depth,
                                               pages=pages[:1]),
            "generate()'s dense prefill (1, 512)":
                lambda net=net, dense=dense: net(ptoks, caches=dense,
                                                 offset=0),
            'forward (1, 512)': lambda net=net: net(ptoks)}
    best = {(t, c): math.inf for t in calls for c in calls[t]}
    with torch.no_grad():
        for t in calls:
            for fn in calls[t].values():
                fn()
        torch.cuda.synchronize()
        names = list(calls)
        for r in range(rounds):
            for c in calls[names[0]]:
                for t in (names if r % 2 == 0 else names[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    calls[t][c]()
                    torch.cuda.synchronize()
                    best[t, c] = min(best[t, c],
                                     (time.perf_counter() - t0) * 1e3)
    for c in calls[names[0]]:
        a, b = best[names[0], c], best[names[1], c]
        log(f'[llama host cost] {c}, llama3_8b widths at {layers} layers: '
            f'this tree {a:.2f} host ms, {other} {b:.2f} ({a / b:.3f}x; '
            f'{(a - b) / layers:+.3f} ms a layer), the least of {rounds} '
            f'in turns ({smi_line()})')
    return best


def ndarray_costs(torch, got, rounds=5, calls=2000):
    """What the frontend costs on the host, beside the card's name and
    power limit: ms per imperative step against the module path's, µs per
    dispatched op (``mx.np.add`` of (4, 4) against ``torch.add``, the least
    of ``rounds`` rounds of ``calls``), and the value-semantics copy of
    ``npx.fused_adam_step`` (every parameter, against the in-place tensor
    function on the same arrays, by CUDA events around calls launched from
    Python)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import optimizer_ops as oo
    smi = smi_line()
    for opt, rows in got['host'].items():
        t, _, _, _, imp, mod, ops = rows[-1]
        log(f'[ndarray] host ms per {opt} step {t}: imperative {imp:.2f}, '
            f'module path {mod:.2f} ({imp / mod:.3f}x); {ops} ops '
            f'dispatched a step; all steps imperative '
            f'{[round(r[4], 2) for r in rows]} module '
            f'{[round(r[5], 2) for r in rows]} ({smi})')
    us_mx, us_t = add_us(torch, mx, rounds, calls)
    log(f'[ndarray] host us per dispatched op, mx.np.add (4, 4): {us_mx:.2f}; '
        f'torch.add: {us_t:.2f}; the frontend adds {us_mx - us_t:.2f} us '
        f'({smi})')
    p, g, net = got['p'], got['g'], got['net']
    slots = {n: (torch.zeros_like(a._data), torch.zeros_like(a._data))
             for n, a in p.items()}
    nd_slots = {n: (mx.NDArray(s[0]), mx.NDArray(s[1]))
                for n, s in slots.items()}
    prms = module_params(net)

    def pure():
        for n in p:
            mx.npx.fused_adam_step(p[n], g[n], *nd_slots[n], lr=1e-5, t=1)

    def inplace():
        with torch.no_grad():
            for n in p:
                oo.fused_adam_step(prms[n], g[n]._data, *slots[n], lr=1e-5,
                                   t=1)

    pure_ms, inplace_ms = eager_ms(torch, pure), eager_ms(torch, inplace)
    n_par = sum(a.size for a in p.values())
    log(f'[ndarray] npx.fused_adam_step over all {len(p)} parameters '
        f'({n_par / 1e9:.3f} B): {pure_ms:.3f} ms with the value-semantics '
        f'copies of w, m, v, against {inplace_ms:.3f} ms in place: the copy '
        f'costs {pure_ms - inplace_ms:.3f} ms a step (bytes moved 13/7 of '
        f'the in-place step\'s) ({smi})')
    return dict(us_mx=us_mx, us_torch=us_t, pure_ms=pure_ms,
                inplace_ms=inplace_ms)


# ------------------------------------------------------------- bert
#: the bert phase: bert_12_768_12 at full width and depth, bench_bert's
#: defaults (bench.py:1082-1083): a (32, 128) batch, MLM labels, token
#: types 0; BERT_STEPS steps of each optimizer from the same seeded weights
BERT_BATCH, BERT_SEQ, BERT_VOCAB = 32, 128, 30522
BERT_STEPS = 3
BERT_OPTS = (('adam', 'adam', {'learning_rate': 1e-4}),
             ('sgd', 'sgd_mom', {'learning_rate': 0.1, 'momentum': 0.9}))
#: parameters the JAX Trainer updates a step for bert_12_768_12 without the
#: NSP classifier (tests/test_torch_bert.py derives it against the JAX
#: Trainer on the CPU): every one, the pooler included, whose gradient an
#: MLM loss leaves at zero
BERT_UPDATED = 156
#: launches a forward: LayerNorm (the embedding's, two a cell, the
#: decoder's) and flash attention (one a cell)
BERT_FORWARD = dict(fused_norm=26, flash_attention=12)


#: resnet phase: bench_resnet_train's defaults (bench.py:302-497, :1082):
#: resnet50_v1 with 1000 classes, a batch of 32 at 3 x 224 x 224, 8 batches
#: through NDArrayIter, SGD-momentum at lr 0.05, 3 warm-up and 6 timed steps
RESNET_BATCH, RESNET_BATCHES = 32, 8
RESNET_WARMUP, RESNET_STEPS = 3, 6
RESNET_OPT = ('sgd', {'learning_rate': 0.05, 'momentum': 0.9})
#: parameters the JAX Trainer updates a step for resnet50_v1 (every one
#: whose grad_req is not 'null': 53 conv weights, 32 bottleneck conv
#: biases, 106 BatchNorm gamma and beta, the Dense weight and bias; not
#: the 106 running statistics; tests/test_torch_vision.py holds it to
#: both packages)
RESNET_UPDATED = 193


def bert_launches(layers):
    """A BERT-base training step's launches at ``layers`` layers: two
    LayerNorms a cell, the embedding's and the decoder's; one attention a
    cell; every parameter's update (12 a cell and 12 outside the cells,
    as BERT_UPDATED counts them)."""
    return {'fused_norm': 2 * layers + 2, 'flash_attention': layers,
            'adam': 12 * layers + 12}


def bert_batch(mx, seed, batch, seq, vocab):
    """Seeded token ids, zero token types and MLM labels on the current
    context, as bench_bert makes them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = mx.np.array(rng.integers(0, vocab, (batch, seq)), dtype='int32')
    tt = mx.np.zeros((batch, seq), dtype='int32')
    labels = mx.np.array(rng.integers(0, vocab, (batch, seq)),
                         dtype='int32')
    return ids, tt, labels


def bert_step(mx, net, trainer, loss_fn, ids, tt, labels):
    """One MLM training step through hybridize, record, backward and the
    Trainer, the reference's imperative path (bench.py:570-576); the loss
    is the batch mean, so the Trainer steps with batch size 1. The MLM
    logits of a bf16 net are cast to fp32 before the loss, as bench's bf16
    train loop takes them (bench.py:548)."""
    with mx.autograd.record():
        _, _, mlm = net(ids, tt)
        if mlm.dtype != 'float32':
            mlm = mlm.astype('float32')
        loss = loss_fn(mlm, labels).mean()
    loss.backward()
    trainer.step(1)
    return loss


def _counts_since(kernels, before):
    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def phase_bert(torch, seed):
    """BERT-base trained through the port's Gluon on ``mx.gpu(0)``: see the
    module docstring. Returns the host numbers :func:`bert_costs` logs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    dev = mx.gpu(0).to_torch()
    t0 = time.perf_counter()
    mx.random.seed(seed)
    net = bert.bert_12_768_12(max_length=BERT_SEQ, dropout=0.0,
                              use_classifier=False)
    net.initialize(ctx=mx.gpu(0))
    ids, tt, labels = bert_batch(mx, seed, BERT_BATCH, BERT_SEQ, BERT_VOCAB)
    params = net.collect_params()
    want_fwd = dict(BERT_FORWARD)
    eager_ms = []
    for _ in range(3):      # deferred init, then the eager reference
        before = kernels.launch_counts()
        _sync(torch, dev)
        t1 = time.perf_counter()
        eager = net(ids, tt)
        _sync(torch, dev)
        eager_ms.append((time.perf_counter() - t1) * 1e3)
        if _counts_since(kernels, before) != want_fwd:
            fail(f'bert: an eager forward launched '
                 f'{_counts_since(kernels, before)}, want {want_fwd}')
    n_par = sum(math.prod(p.shape) for p in params.values())
    log(f'[bert] bert_12_768_12 (12 layers, 768 units, 12 heads of 64, FFN '
        f'3072, vocab {BERT_VOCAB}) without the NSP head: {len(params)} '
        f'parameters, {n_par / 1e6:.2f} M fp32, built, initialized and run '
        f'once on {ids.context} in {time.perf_counter() - t0:.1f} s')
    init = {k: p.data()._data.detach().clone() for k, p in params.items()}

    net.hybridize(static_alloc=True)
    graph_ms = []
    for i in range(3):
        before = kernels.launch_counts()
        _sync(torch, dev)
        t1 = time.perf_counter()
        outs = net(ids, tt)
        _sync(torch, dev)
        graph_ms.append((time.perf_counter() - t1) * 1e3)
        got = _counts_since(kernels, before)
        errs = [compare(torch, g._data, w._data, 1e-5, 1e-6)
                for g, w in zip(outs, eager)]
        log(f'[bert] hybridized predict call {i + 1}: launches {got}, '
            f'max |diff| against the eager forward '
            f'{[float(f"{e:.3g}") for e, _ in errs]} (rtol 1e-5, atol 1e-6: '
            f'the same kernels in the same order) -> '
            f'{"ok" if all(ok for _, ok in errs) else "MISMATCH"}')
        if got != want_fwd or not all(ok for _, ok in errs):
            fail(f'bert: hybridized predict call {i + 1} launched {got} '
                 f'(want {want_fwd}) or parts from the eager forward')
    if net.capture_count != 1 or net.compile_count != 1:
        fail(f'bert: {net.capture_count} captures and {net.compile_count} '
             f'cache keys over three predict calls, want 1 and 1')
    log(f'[bert] one capture, no re-capture over three predict calls; host '
        f'ms a forward: eager {[round(x, 2) for x in eager_ms]}, hybridized '
        f'{[round(x, 2) for x in graph_ms]} (the first captures); card '
        f'{smi_line()}')
    del outs

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    steps, graphed_steps, busy, peaks, groups = {}, {}, {}, {}, {}
    for run, (opt, kernel, hyper) in enumerate(BERT_OPTS):
        want = dict(want_fwd, **{kernel: BERT_UPDATED})
        got_runs = {}
        for graphed in (False, True):
            # eager steps, then graphed steps from the same weights
            for k, p in params.items():
                p.set_data(init[k])
            net.hybridize(graphed, static_alloc=True)
            mem = _memory_start(torch, dev)
            if graphed:         # a predict graph, replayed after training
                net(ids, tt)
            trainer = gluon.Trainer(params, opt, dict(hyper))
            tag = 'graphed' if graphed else 'eager'
            losses, wall = [], []

            def step():
                loss = bert_step(mx, net, trainer, loss_fn, ids, tt, labels)
                _sync(torch, dev)
                return loss

            for i in range(BERT_STEPS):
                last = run == 0 and i == BERT_STEPS - 1
                if last:    # checked, and run again from its start if short
                    prof, loss, ms, got = profile_checked(
                        torch, f'bert {tag} Adam step', step,
                        Rewind(torch, trainer))
                    wall.append(ms)
                else:
                    before = kernels.launch_counts()
                    _sync(torch, dev)
                    t1 = time.perf_counter()
                    loss = step()
                    wall.append((time.perf_counter() - t1) * 1e3)
                    got = _counts_since(kernels, before)
                losses.append(loss.item())
                if got != want:
                    fail(f'bert: {tag} {opt} step {i + 1} launches {got}, '
                         f'want {want}')
                if last:    # against the step before, which no profiler
                    log(f'[bert] {tag} Adam step profiled:')     # slowed
                    groups[tag] = bert_breakdown(torch, prof, wall[-2])
                    busy[tag] = _busy_share(prof, wall[-2])
                del loss
            state = {k: p.data()._data.detach().clone()
                     for k, p in params.items()}
            got_runs[graphed] = (losses, state)
            moved = [k for k in params if not torch.equal(state[k], init[k])]
            still = sorted(set(params) - set(moved))
            log(f'[bert] {tag} {opt} {hyper}: losses {losses}; host ms a '
                f'step {[round(w, 2) for w in wall]}; '
                f'{BERT_BATCH / wall[-2] * 1e3:.1f} samples/s at step '
                f'{BERT_STEPS - 1}; launches a step {want}; {len(moved)} '
                f'parameters moved, unchanged (no gradient from the MLM '
                f'loss): {still}')
            if not all(math.isfinite(v) for v in losses):
                fail(f'bert: {tag} {opt} losses not finite: {losses}')
            if not losses[-1] < losses[0]:
                fail(f'bert: {tag} {opt} loss did not fall: {losses}')
            if still != ['pooler.bias', 'pooler.weight']:
                fail(f'bert: {tag} {opt} left {still} unchanged; only the '
                     f'pooler gets no gradient from the MLM loss')
            (graphed_steps if graphed else steps)[opt] = wall
            peaks[tag] = max(peaks.get(tag, (0.0, 0.0)),
                             _memory_peaks(torch, dev, mem))
            if graphed:
                graph_counts(net, trainer, 'bert', want_captures=3)
            del trainer
        graphed_agrees('bert', opt, init, got_runs)
        del got_runs

    # a predict replay after Trainer.step reads the updated weights in place
    before = kernels.launch_counts()
    outs = net(ids, tt)
    got = _counts_since(kernels, before)
    with mx.autograd.predict_mode():
        want_out = net.forward(ids, tt)
    err, ok = compare(torch, outs[2]._data, want_out[2]._data, 1e-5, 1e-6)
    log(f'[bert] predict call after graphed training: launches {got}, '
        f'{net.capture_count} graph(s) in all, MLM logits against an eager '
        f'forward of the trained weights {err:.3g} -> '
        f'{"ok" if ok else "MISMATCH"}')
    if not ok or net.capture_count != 3 or got != want_fwd:
        fail('bert: the replayed graph did not see the trained weights, '
             'captured again or launched other kernels')
    del outs, want_out, eager
    graphed_checks(torch, mx, dev)
    return dict(eager_ms=eager_ms, graph_ms=graph_ms, steps=steps,
                graphed_steps=graphed_steps, busy=busy, peaks=peaks,
                groups=groups, net=net)


def _memory_start(torch, dev):
    """Empty the allocator's cache and start a run's memory window;
    returns what :func:`_memory_peaks` measures from."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return (torch.cuda.memory_allocated(dev),
            torch.cuda.memory_reserved(dev))


def _memory_peaks(torch, dev, start):
    """GiB above ``start`` at the run's peak: allocated tensors, and
    reserved memory (a captured graph's activations live in its pool,
    which counts as reserved but not as allocated once the capture's
    tensors are freed)."""
    return ((torch.cuda.max_memory_allocated(dev) - start[0]) / 2**30,
            (torch.cuda.max_memory_reserved(dev) - start[1]) / 2**30)


def _busy_share(prof, wall_ms):
    """Kernel ms over host ms of one profiled step."""
    from torch.autograd import DeviceType
    ms = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0) / 1e3
    return ms / wall_ms


def graph_counts(net, trainer, tag, want_captures):
    """A graphed run's captures: the net's forward and backward graphs
    (and a predict graph), the Trainer's one update graph; no recorded
    call ran eagerly."""
    got = (net.capture_count, trainer.capture_count, net.eager_call_count)
    log(f'[{tag}] graphs captured: net {got[0]} (a forward and a backward '
        f'for the recorded key, one for the predict key), Trainer '
        f'{got[1]} (the update); recorded calls run eagerly {got[2]}')
    if got != (want_captures, 1, 0):
        fail(f'{tag}: captures (net, Trainer, eager recorded calls) {got}, '
             f'want ({want_captures}, 1, 0): a step captured again')


def graphed_agrees(tag, what, init, runs, n=3):
    """The graphed steps against the eager ones from the same state: the
    first ``n`` losses at rtol 1e-4, and each tensor's change over the
    steps within 1 % of the eager change in the 2-norm (the rule
    :func:`resnet_parity` holds two fp32 libraries to)."""
    (el, _), (gl, _) = runs[False], runs[True]
    ok = all(math.isclose(a, b, rel_tol=1e-4)
             for a, b in zip(gl[:n], el[:n]))
    bad, worst = _change_gaps(init, runs)
    log(f'[{tag}] {what}, graphed against eager: losses {gl[:n]} and '
        f'{el[:n]} (rtol 1e-4); |graphed change - eager change| over |eager '
        f'change|, worst {worst} (1e-2) -> '
        f'{"ok" if ok and not bad else "MISMATCH"}')
    if not ok or bad:
        fail(f'{tag}: the graphed {what} steps train apart from the eager '
             f'ones: losses {gl[:n]} against {el[:n]}; past tolerance {bad}')


def _change_gaps(init, runs, tol=1e-2):
    """Each tensor's change from ``init`` in ``runs[True]`` against
    ``runs[False]``: ``|change - change| / |change|`` in the 2-norm.
    Returns the tensors past ``tol`` and the worst three."""
    (_, ew), (_, gw) = runs[False], runs[True]
    rel = {}
    for k, w0 in init.items():
        de, dg = (ew[k] - w0).double(), (gw[k] - w0).double()
        rel[k] = float((dg - de).norm()) / max(float(de.norm()), 1e-30)
    bad = sorted(k for k, r in rel.items() if not r <= tol)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    return bad, [(k, float(f'{r:.3g}')) for k, r in worst]


def graphed_checks(torch, mx, dev):
    """The graphed node's hazards on the card: a Dropout drawing a fresh
    mask on every replay, two recorded calls of one key before one
    backward, and ``create_graph`` through a replayed call."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import nn
    g = torch.Generator(device=dev).manual_seed(SEED)
    # Dense(1024) with an identity weight, then Dropout(0.5): the input's
    # gradient is exactly the mask times 2 times the head gradient
    net = nn.HybridSequential(nn.Dense(1024, in_units=1024),
                              nn.Dropout(0.5))
    net.initialize(ctx=mx.gpu(0))
    params = net.collect_params()
    params['0.weight'].set_data(torch.eye(1024, device=dev))
    params['0.bias'].set_data(torch.zeros(1024, device=dev))
    x = mx.NDArray(torch.randn(1024, 1024, device=dev, generator=g) + 8.0)
    net(x)
    net.hybridize()
    masks, exact = [], []
    for _ in range(4):
        x.attach_grad()
        head = torch.randn(1024, 1024, device=dev, generator=g)
        with mx.autograd.record():
            out = net(x)
        out.backward(mx.NDArray(head))
        mask = out._data != 0
        masks.append(mask)
        exact.append(torch.equal(x.grad._data, mask * 2.0 * head))
    kept = float(masks[-1].float().mean())
    fresh = not torch.equal(masks[-2], masks[-1])
    log(f'[graphs] Dense(1024) -> Dropout(0.5) recorded 4 times (a capture, '
        f'then replays; {net.capture_count} graphs): masks of the last two '
        f'replays differ {fresh}, kept share {kept:.5f} of 1048576 (0.5 '
        f'within 1 %), x.grad equal to mask x 2 x head gradient {exact}')
    if not (fresh and abs(kept - 0.5) < 5e-3 and all(exact)
            and net.capture_count == 2):
        fail('graphs: a graphed Dropout replayed its mask, kept another '
             'share, or its gradient is not its own mask\'s')
    drop = net
    # two recorded calls of one key before one backward
    grads = {}
    x1 = mx.NDArray(torch.randn(64, 1024, device=dev, generator=g))
    x2 = mx.NDArray(torch.randn(64, 1024, device=dev, generator=g))
    net = nn.HybridSequential(nn.Dense(512, in_units=1024),
                              nn.BatchNorm(in_channels=512),
                              nn.Dense(16, in_units=512))
    net.initialize(ctx=mx.gpu(0))
    net(x1)
    init = {k: p.data()._data.clone() for k, p in
            net.collect_params().items()}
    for graphed in (False, True):
        for k, p in net.collect_params().items():
            p.set_data(init[k])
        net.hybridize(graphed)
        for _ in range(2):
            with mx.autograd.record():      # capture, then one replay
                loss = (net(x1) ** 2).mean()
            loss.backward()
        with mx.autograd.record():
            loss = (net(x1) ** 2).mean() + (net(x2) * 3).mean()
        loss.backward()
        grads[graphed] = {k: p.grad()._data.clone()
                          for k, p in net.collect_params().items()
                          if p.grad_req != 'null'}
    errs = [compare(torch, grads[True][k], v, 1e-5, 1e-6)
            for k, v in grads[False].items()]
    log(f'[graphs] two recorded calls of one key before one backward: the '
        f'second ran eagerly ({net.eager_call_count} counted); gradients '
        f'against eager, max |diff| {max(e for e, _ in errs):.3g} (rtol '
        f'1e-5) -> {"ok" if all(ok for _, ok in errs) else "MISMATCH"}')
    if net.eager_call_count != 1 or not all(ok for _, ok in errs):
        fail('graphs: a second recorded call of a key overwrote the first '
             'call\'s activations')
    # create_graph through a replayed call of the Dropout net: an eager
    # recomputation would draw other masks (the gluon phase's (b) holds
    # the call that draws nothing)
    x.attach_grad()
    with mx.autograd.record():
        out = (drop(x) ** 2).sum()
    try:
        mx.autograd.grad(out, [x], create_graph=True)
        fail('graphs: create_graph=True through a replayed call that draws '
             'did not raise')
    except MXNetError as e:
        log(f'[graphs] create_graph=True through a replayed call that '
            f'draws raises: {str(e)[:100]}...')
        if 'random' not in str(e):
            fail(f'graphs: the create_graph error does not name the random '
                 f'numbers: {e}')


def bert_breakdown(torch, prof, wall_ms):
    """Split one profiled BERT train step's kernel time: cuBLAS's GEMMs,
    B1, B2, the optimizer kernels and the rest (elementwise, softmax,
    reductions, embedding gathers, copies; the plain flash backward's
    products are among the GEMMs, its softmax among the rest)."""
    from torch.autograd import DeviceType
    busy = kernel_breakdown('bert', 'train step (Adam, profiled; host ms '
                            'of the unprofiled step before)', prof, wall_ms,
                            top=10)
    groups = {'B1 fused_norm': ('fused_norm',),
              'B2 flash_fwd': ('flash_fwd',),
              'B5/B6 optimizer': ('adam_kernel', 'sgd_mom_kernel'),
              'cuBLAS GEMMs': ('gemm', 'Gemm', 'GEMM')}
    sums = dict.fromkeys(list(groups) + ['other'], 0.0)
    counts = dict.fromkeys(sums, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        g = next((g for g, keys in groups.items()
                  if any(k in e.key for k in keys)), 'other')
        sums[g] += e.self_device_time_total / 1e3
        counts[g] += e.count
    log('[bert] kernel ms of the step by group: ' + ', '.join(
        f'{g} {ms:.2f} ({100 * ms / max(busy, 1e-9):.1f} %, x{counts[g]})'
        for g, ms in sums.items()))
    return sums


def bert_costs(torch, got):
    """Log the bert phase's host numbers beside cuBLAS's fp32 GEMM rate and
    the plain flash backward, each measured here."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    net = got['net']
    dev = torch.device('cuda', 0)
    tokens = BERT_BATCH * BERT_SEQ
    mm = [p for k, p in net.collect_params().items()
          if k.endswith('.weight') and len(p.shape) == 2
          and not k.startswith(('token_type', 'pooler'))]
    flops = 6 * tokens * sum(math.prod(p.shape) for p in mm)
    a = torch.randn(tokens, 768, device=dev)
    b = torch.randn(768, 3072, device=dev)
    gemm_ms = cuda_ms(torch, lambda: a @ b)
    rate = 2 * tokens * 768 * 3072 / gemm_ms / 1e9
    q = torch.randn(BERT_BATCH * 12, BERT_SEQ, 64, device=dev)
    bwd_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd(
        q, q, q, q, 0.125, False))
    for tag, runs in (('eager', got['steps']),
                      ('graphed', got['graphed_steps'])):
        for opt, wall in runs.items():
            step = wall[-2]
            log(f'[bert] {tag} {opt}: {step:.2f} host ms a step, '
                f'{BERT_BATCH / step * 1e3:.1f} samples/s; the step\'s GEMMs '
                f'are {flops / 1e12:.3f} TFLOP (6 x '
                f'{sum(math.prod(p.shape) for p in mm) / 1e6:.1f} M weights '
                f'in products x {tokens} tokens), {flops / step / 1e9:.1f} '
                f'TFLOP/s over the host step against cuBLAS\'s fp32 (4096 x '
                f'768) @ (768 x 3072) at {rate:.1f} TFLOP/s ({gemm_ms:.4f} '
                f'ms) in this run')
    log(f'[bert] busy share of the profiled Adam step: eager '
        f'{100 * got["busy"]["eager"]:.1f} %, graphed '
        f'{100 * got["busy"]["graphed"]:.1f} %; peak memory above a run\'s '
        f'start, allocated and reserved: eager '
        f'{got["peaks"]["eager"][0]:.2f} and {got["peaks"]["eager"][1]:.2f} '
        f'GiB, graphed {got["peaks"]["graphed"][0]:.2f} and '
        f'{got["peaks"]["graphed"][1]:.2f} GiB')
    log(f'[bert] plain flash backward at the step\'s (384, 128, 64): '
        f'{bwd_ms:.4f} ms a call, x12 a step; hybridized predict '
        f'{got["graph_ms"][-1]:.2f} host ms against eager '
        f'{got["eager_ms"][-1]:.2f}; card {smi_line()}')


def bert_parity(torch, seed, steps=2):
    """A small BERT (2 layers, 128 units, 2 heads of 64, vocab 1000) trains
    ``steps`` Adam steps on a (4, 32) batch on the card, through the
    kernels, and on the CPU, through the plain versions, from the same
    weights: the losses must agree at rtol 1e-4."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    cfg = dict(vocab_size=1000, num_layers=2, units=128, hidden_size=512,
               num_heads=2, max_length=32, dropout=0.0, use_classifier=False)
    losses, weights = {}, None
    for where in (mx.cpu(), mx.gpu(0)):
        with where:
            mx.random.seed(seed)
            net = bert.get_bert_model('bert_12_768_12', **cfg)
            net.initialize(ctx=where)
            batch = bert_batch(mx, seed, 4, 32, 1000)
            net(*batch[:2])             # deferred initialization
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                net.load_dict(weights)
            net.hybridize()
            trainer = gluon.Trainer(net.collect_params(), 'adam',
                                    {'learning_rate': 1e-3})
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            losses[str(where)] = [
                bert_step(mx, net, trainer, loss_fn, *batch).item()
                for _ in range(steps)]
    cpu, card = losses['cpu(0)'], losses['gpu(0)']
    ok = all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(card, cpu))
    log(f'[bert] small BERT (2 layers, 128 units, 2 heads of 64), {steps} '
        f'Adam steps: losses on the card {card}, on the CPU {cpu} (rtol '
        f'1e-4) -> {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('bert: the card and the CPU train the small BERT apart')


# ------------------------------------------------------------- resnet
#: bench.py:55: resnet50's forward is 7.72 GFLOP an image; a training step
#: (forward, backward) about three times that
RESNET50_FWD_FLOPS = 7.72e9


def resnet_data(seed, n):
    """``n`` seeded images at 3 x 224 x 224 (N(0, 0.1)) and integer labels
    0-999 stored as float32, as bench_resnet_train makes them
    (bench.py:397-400)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 3, 224, 224), dtype=np.float32) * 0.1
    labels = rng.integers(0, 1000, n).astype(np.float32)
    return images, labels


def resnet_step(mx, net, trainer, loss_fn, x, y):
    """One step of bench_resnet_train's imperative loop (bench.py:413-426):
    record, forward, the mean loss, backward, ``trainer.step(batch)``; the
    logits of a bf16 net are cast to fp32 before the loss, as the loop
    does."""
    with mx.autograd.record():
        out = net(x)
        if out.dtype != 'float32':
            out = out.astype('float32')
        loss = loss_fn(out, y).mean()
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def _tf32_conv_check(torch, mx, dev):
    """One of resnet50's 3 x 3 convolutions (64 -> 64 channels at 56 x 56,
    a batch of 32) through the port's ``Conv2D`` and through
    ``F.conv2d``, with cuDNN's TF32 flag left on as PyTorch sets it, each
    against the same convolution in fp64: the port's must be fp32."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.gluon import nn
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(RESNET_BATCH, 64, 56, 56, generator=g, device=dev)
    conv = nn.Conv2D(64, 3, padding=1, use_bias=False, in_channels=64)
    conv.initialize(ctx=mx.gpu(0))
    w = conv.weight.data()._data.detach()
    want = F.conv2d(x.double(), w.double(), padding=1)
    scale = float(want.abs().max())
    got = conv(mx.NDArray(x))._data.detach()
    port = float((got.double() - want).abs().max()) / scale
    lib = float((F.conv2d(x, w, padding=1).double() - want).abs().max()) \
        / scale
    log(f'[resnet] conv 64 -> 64, 3 x 3 at (32, 64, 56, 56), cuDNN TF32 flag '
        f'{torch.backends.cudnn.allow_tf32}: max error over max |out| '
        f'against fp64: port Conv2D {port:.3g}, F.conv2d {lib:.3g} (fp32: '
        f'under 1e-5)')
    if port > 1e-5:
        fail(f'resnet: the port\'s Conv2D ran in TF32 ({port:.3g} off fp64)')


def phase_resnet(torch, seed):
    """ResNet-50 trained through the port's Gluon, io and metric on
    ``mx.gpu(0)``, with cuDNN's TF32 flag on, as PyTorch sets it: see the
    module docstring. Returns what :func:`resnet_costs` logs."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _resnet_phase(torch, seed)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _resnet_phase(torch, seed):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, io, metric
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import kernels
    dev = mx.gpu(0).to_torch()
    log(f'[resnet] at the phase\'s start: '
        f'{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, '
        f'{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved')
    _tf32_conv_check(torch, mx, dev)
    t0 = time.perf_counter()
    mx.random.seed(seed)
    net = vision.resnet50_v1()
    net.initialize(ctx=mx.gpu(0))
    images, labels = resnet_data(seed, RESNET_BATCH * RESNET_BATCHES)
    it = io.NDArrayIter(images, labels, batch_size=RESNET_BATCH,
                        shuffle=False)
    batches = [(b.data[0].as_in_context(mx.gpu(0)),
                b.label[0].as_in_context(mx.gpu(0))) for b in it]
    x0, y0 = batches[0]
    eager_ms = []
    for _ in range(3):      # deferred initialization, then the reference
        before = kernels.launch_counts()
        _sync(torch, dev)
        t1 = time.perf_counter()
        eager = net(x0)
        _sync(torch, dev)
        eager_ms.append((time.perf_counter() - t1) * 1e3)
        if _counts_since(kernels, before):
            fail(f'resnet: an eager forward launched '
                 f'{_counts_since(kernels, before)}, want no kernel')
    params = net.collect_params()
    n_par = sum(math.prod(p.shape) for p in params.values()
                if p.grad_req != 'null')
    log(f'[resnet] resnet50_v1 (1000 classes, fp32): {len(params)} '
        f'parameters ({sum(p.grad_req != "null" for p in params.values())} '
        f'trained, {n_par / 1e6:.2f} M values), built, initialized and run '
        f'once on {x0.context} in {time.perf_counter() - t0:.1f} s; '
        f'{len(batches)} batches of {tuple(x0.shape)} from NDArrayIter')
    init = {k: p.data()._data.detach().clone() for k, p in params.items()}

    net.hybridize(static_alloc=True)
    graph_ms = []
    for i in range(3):
        before = kernels.launch_counts()
        _sync(torch, dev)
        t1 = time.perf_counter()
        out = net(x0)
        _sync(torch, dev)
        graph_ms.append((time.perf_counter() - t1) * 1e3)
        err, ok = compare(torch, out._data, eager._data, 1e-5, 1e-6)
        log(f'[resnet] hybridized predict call {i + 1}: launches '
            f'{_counts_since(kernels, before)}, max |diff| against the '
            f'eager forward {err:.3g} (rtol 1e-5, atol 1e-6: the same '
            f'kernels in the same order) -> {"ok" if ok else "MISMATCH"}')
        if not ok or _counts_since(kernels, before):
            fail(f'resnet: hybridized predict call {i + 1} parts from the '
                 f'eager forward or launched a kernel')
    if net.capture_count != 1 or net.compile_count != 1:
        fail(f'resnet: {net.capture_count} captures and {net.compile_count} '
             f'cache keys over three predict calls, want 1 and 1')
    acc, top5 = metric.Accuracy(), metric.TopKAccuracy(5)
    for m in (acc, top5):
        m.update([y0], [out])
    log(f'[resnet] one capture, no re-capture over three predict calls; '
        f'host ms a forward: eager {[round(t, 2) for t in eager_ms]}, '
        f'hybridized {[round(t, 2) for t in graph_ms]} (the first '
        f'captures); on batch 0 of the random net {acc.get()} '
        f'{top5.get()}; card {smi_line()}')
    del out

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    want = {'sgd_mom': RESNET_UPDATED}

    def steps(n, get, tag, trainer, profile_last=False):
        losses, wall, prof = [], [], None
        for i in range(n):
            x, y = get(i)

            def step():
                loss = resnet_step(mx, net, trainer, loss_fn, x, y)
                _sync(torch, dev)
                return loss

            if profile_last and i == n - 1:
                prof, loss, ms, got = profile_checked(
                    torch, f'resnet {tag} step', step,
                    Rewind(torch, trainer))
                wall.append(ms)
            else:
                before = kernels.launch_counts()
                _sync(torch, dev)
                t1 = time.perf_counter()
                loss = step()
                wall.append((time.perf_counter() - t1) * 1e3)
                got = _counts_since(kernels, before)
            losses.append(loss.item())
            if got != want:
                fail(f'resnet: {tag} step {i + 1} launched {got}, want '
                     f'{want}')
        if not all(math.isfinite(v) for v in losses):
            fail(f'resnet: {tag} losses not finite: {losses}')
        return losses, wall, prof

    def dev_get(i):
        return batches[i % len(batches)]

    # graphed against eager: three steps of each from the same weights,
    # statistics and (fresh) slots, under deterministic cuDNN. Its default
    # weight-gradient kernels sum with atomics in no fixed order, and at
    # this learning rate two eager runs with them part by tens of per cent
    # in some tensors' three-step change (logged first); with
    # deterministic kernels two eager runs are bit-equal.
    def three_steps(graphed, tag):
        for k, p in params.items():
            p.set_data(init[k])
        net.hybridize(graphed, static_alloc=True)
        trainer = gluon.Trainer(params, RESNET_OPT[0], dict(RESNET_OPT[1]))
        losses, _, _ = steps(RESNET_WARMUP, dev_get, tag, trainer)
        if graphed:
            graph_counts(net, trainer, 'resnet', want_captures=2)
        return losses, {k: p.data()._data.detach().clone()
                        for k, p in params.items()}

    noise = {g: three_steps(False, 'eager (default cuDNN)')
             for g in (False, True)}
    _, worst = _change_gaps(init, noise)
    log(f'[resnet] two eager runs with cuDNN\'s default kernels: losses '
        f'{noise[True][0]} and {noise[False][0]}; |change - change| over '
        f'|change|, worst {worst}')
    del noise
    torch.backends.cudnn.deterministic = True
    try:
        agree = {g: three_steps(g, f'{"graphed" if g else "eager"} '
                                   f'(deterministic cuDNN)')
                 for g in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = False
    graphed_agrees('resnet', 'SGD-momentum (deterministic cuDNN)', init,
                   agree)
    del agree

    runs = {}
    for graphed in (False, True):
        # the timed runs, with cuDNN's default kernels: eager steps, then
        # graphed steps from the same weights, statistics and fresh slots
        tag = 'graphed' if graphed else 'eager'
        for k, p in params.items():
            p.set_data(init[k])
        net.hybridize(graphed, static_alloc=True)
        mem = _memory_start(torch, dev)
        if graphed:             # a predict graph, replayed after training
            net(x0)
        trainer = gluon.Trainer(params, RESNET_OPT[0], dict(RESNET_OPT[1]))
        warm, warm_wall, _ = steps(RESNET_WARMUP, dev_get,
                                   f'{tag} warm-up', trainer)
        # the timed steps run back to back as bench's loop does, one sync
        # at the end; then the same steps synced one by one, for host ms
        _sync(torch, dev)
        t1 = time.perf_counter()
        for i in range(RESNET_STEPS):
            loss = resnet_step(mx, net, trainer, loss_fn, *dev_get(i))
        loop_loss = loss.item()
        loop_ms = (time.perf_counter() - t1) * 1e3
        losses, wall, prof = steps(RESNET_STEPS, dev_get, f'{tag} timed',
                                   trainer, profile_last=True)
        img_s = RESNET_STEPS * RESNET_BATCH / loop_ms * 1e3
        log(f'[resnet] {tag} {RESNET_OPT}: warm-up losses {warm}, host ms '
            f'{[round(t, 2) for t in warm_wall]}; {RESNET_STEPS} steps back '
            f'to back {loop_ms:.2f} ms ({loop_ms / RESNET_STEPS:.2f} ms a '
            f'step, {img_s:.1f} img/s, last loss {loop_loss}); then synced '
            f'one by one: losses {losses}, host ms a step '
            f'{[round(t, 2) for t in wall]} (the last profiled); launches a '
            f'step {want}')
        log(f'[resnet] {tag} step profiled:')
        breakdown = resnet_breakdown(torch, prof, wall[-2])

        moved = [k for k, p in params.items()
                 if not torch.equal(p.data()._data, init[k])]
        still = sorted(set(params) - set(moved))
        log(f'[resnet] {tag}: {len(moved)} of {len(params)} parameters and '
            f'running statistics moved; unchanged: {still}')
        if still:
            fail(f'resnet: {tag}: {still} did not move over the steps')
        if graphed:
            # a predict replay after training reads the running
            # statistics in place
            before = kernels.launch_counts()
            out = net(x0)
            with mx.autograd.predict_mode():
                want_out = net.forward(x0)
            err, ok = compare(torch, out._data, want_out._data, 1e-5, 1e-6)
            log(f'[resnet] predict call after graphed training: launches '
                f'{_counts_since(kernels, before)}, against an eager forward '
                f'with the new running statistics {err:.3g} -> '
                f'{"ok" if ok else "MISMATCH"}')
            if not ok or _counts_since(kernels, before):
                fail('resnet: the replayed graph did not see the trained '
                     'weights and statistics, or launched a kernel')
            del out, want_out
        fed_img_s = _resnet_host_fed(torch, mx, io, images, labels, x0, y0,
                                     steps, trainer, net, loss_fn, tag)
        if graphed:
            graph_counts(net, trainer, 'resnet', want_captures=3)
        runs[tag] = dict(loop_ms=loop_ms, img_s=img_s, fed_img_s=fed_img_s,
                         wall=wall, breakdown=breakdown,
                         peak=_memory_peaks(torch, dev, mem))
        del trainer
    del eager
    kstep = resnet_kstep(torch, net, x0, dev)
    return dict(runs=runs, kstep=kstep, eager_ms=eager_ms,
                graph_ms=graph_ms)


def _resnet_host_fed(torch, mx, io, images, labels, x0, y0, steps, trainer,
                     net, loss_fn, tag):
    """The same steps fed by ``PrefetchingIter`` (bench.py:463-485);
    returns img/s."""
    dev = x0._data.device
    pref = io.PrefetchingIter(
        io.NDArrayIter(images, labels, batch_size=RESNET_BATCH,
                       shuffle=False), ctx=x0.context, depth=3)
    first = next(pref)
    if not (torch.equal(first.data[0]._data, x0._data)
            and torch.equal(first.label[0]._data, y0._data)):
        fail('resnet: the first PrefetchingIter batch is not NDArrayIter\'s')
    fed = [first]

    def pref_get(i):
        if fed:
            b = fed.pop()
        else:
            try:
                b = next(pref)
            except StopIteration:
                pref.reset()
                b = next(pref)
        return b.data[0], b.label[0]

    steps(2, pref_get, f'{tag} host-fed warm-up', trainer)
    _sync(torch, dev)
    t1 = time.perf_counter()
    for i in range(RESNET_STEPS):
        loss = resnet_step(mx, net, trainer, loss_fn, *pref_get(i))
    loss.item()
    fed_ms = (time.perf_counter() - t1) * 1e3
    pref.close()
    fed_img_s = RESNET_STEPS * RESNET_BATCH / fed_ms * 1e3
    log(f'[resnet] {tag} host-fed (PrefetchingIter over NDArrayIter, ctx '
        f'gpu(0), depth 3; the first batch equal to NDArrayIter\'s): '
        f'{RESNET_STEPS} steps {fed_ms:.2f} ms, {fed_img_s:.1f} img/s')
    return fed_img_s


#: the reference's primary ResNet-50 number: K steps as one program
#: (bench.py:302-370; K = bench's suite-mode iters, bench.py:962)
RESNET_K = 24


def resnet_kstep(torch, net, x0, dev, k=RESNET_K):
    """bench_resnet_train's K-step loop over ``pure_function(x0,
    train=True)``: one step (input ``x0 * (1 + 2**-6 * i)`` with ``i`` a
    counter on the card, log-softmax NLL against labels ``arange(B) %
    1000``, gradients from ``torch.autograd.grad``, SGD-momentum through
    B6 and its device vector, the new running statistics written back) is
    captured once and replayed ``k`` times with no host sync between. The
    first three losses must equal the same step run eagerly (rtol 1e-4;
    BF16_LOSS_RTOL for a bf16 net, whose weights take B6's plain version,
    counted as plain updates, with fp32 momenta as bench keeps them,
    bench.py:336-337). Returns img/s."""
    from mxnet_tpu_torch import _graphs
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import fused_optimizer as fo
    fn, ins, mains0, auxs0 = net.pure_function(x0, train=True)
    batch = x0.shape[0]
    bf16 = mains0[0].dtype != torch.float32
    rtol = BF16_LOSS_RTOL if bf16 else 1e-4
    labels = torch.arange(batch, device=dev) % 1000
    rows = torch.arange(batch, device=dev)
    opt = RESNET_OPT[1]
    hyper = torch.tensor([opt['learning_rate'], 0.0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def state():
        return dict(mains=[t.clone().requires_grad_() for t in mains0],
                    moms=[torch.zeros_like(t, dtype=torch.float32)
                          for t in mains0],
                    auxs=[t.clone() for t in auxs0],
                    i=torch.zeros((), device=dev),
                    losses=torch.zeros(k + 1, device=dev))

    def make(st):
        def step():
            x = ins[0] * (1.0 + 2.0 ** -6 * st['i'])
            outs, new_aux = fn(gen, (x,), st['mains'], st['auxs'])
            logp = torch.log_softmax(outs[0].float(), -1)
            loss = -logp[rows, labels].mean()
            grads = torch.autograd.grad(loss, st['mains'])
            with torch.no_grad():
                for w, g, m in zip(st['mains'], grads, st['moms']):
                    fo.sgd_mom_step(w.detach(), g, m, hyper,
                                    momentum=opt['momentum'])
                for a, new in zip(st['auxs'], new_aux):
                    a.copy_(new)
                st['losses'].index_copy_(0, st['i'].long().view(1),
                                         loss.detach().view(1))
                st['i'].add_(1.0)
        return step

    # the first three losses against the eager step's, under deterministic
    # cuDNN (see _resnet_phase), then the timed loop with its default
    # kernels, captured anew
    torch.backends.cudnn.deterministic = True
    try:
        eager = state()
        step = make(eager)
        for _ in range(3):
            step()
        want = eager['losses'][:3].tolist()
        del eager, step
        st = state()
        graph = _graphs.StepGraph(make(st), dev, generators=(gen,))
        graph.capture()             # its warm-up is step 0
        graph.replay(times=2)
        got = st['losses'][:3].tolist()
        graph.release()
        del graph, st
    finally:
        torch.backends.cudnn.deterministic = False
    ok = all(math.isclose(a, b, rel_tol=rtol) for a, b in zip(got, want))
    log(f'[resnet] K-step loop over pure_function{" (bf16)" * bf16}, '
        f'deterministic cuDNN: losses of its warm-up and two replays {got} '
        f'against the eager step\'s {want} (rtol {rtol}) -> '
        f'{"ok" if ok else "MISMATCH"}')
    st = state()
    before = kernels.launch_counts()
    plain0 = kernels.plain_update_counts()
    graph = _graphs.StepGraph(make(st), dev, generators=(gen,))
    graph.capture()                 # its warm-up is step 0
    _sync(torch, dev)
    t1 = time.perf_counter()
    graph.replay(times=k)
    _sync(torch, dev)
    ms = (time.perf_counter() - t1) * 1e3
    losses = st['losses'].tolist()
    launches = _counts_since(kernels, before)
    plain = _plain_since(kernels, plain0)
    img_s = k * batch / ms * 1e3
    log(f'[resnet] K-step loop over pure_function{" (bf16)" * bf16} (K = '
        f'{k}, one captured step replayed K times, no host sync between): '
        f'{ms:.2f} ms, {ms / k:.2f} ms a step, {img_s:.1f} img/s; launches '
        f'{launches}, plain updates {plain} over its warm-up and {k} '
        f'replays; losses {losses[:4]}... last {losses[-1]}; card '
        f'{smi_line()}')
    updates = {'sgd_mom': RESNET_UPDATED * (k + 1)}
    if not ok or (launches, plain) != (({}, updates) if bf16 else
                                       (updates, {})) or \
            not all(math.isfinite(v) for v in losses):
        fail('resnet: the K-step loop parts from the eager steps, is not '
             'finite, or took other than B6 (its plain version for bf16) '
             'once a parameter a step')
    graph.release()
    return dict(ms=ms, img_s=img_s)


#: kernel groups of a ResNet-50 step, matched on the kernel's name in order
#: (cuDNN's implicit-GEMM convolutions have "gemm" in their names too)
RESNET_GROUPS = (
    ('conv backward (weight)', ('wgrad', 'Wgrad', 'wgrad_alg')),
    ('conv backward (data)', ('dgrad', 'Dgrad')),
    ('conv forward', ('fprop', 'Fprop', 'implicit_convolve', 'conv2d',
                      'convolve', 'xmma')),
    ('conv layout transforms', ('nchwToNhwc', 'nhwcToNchw', 'NchwToNhwc',
                                'NhwcToNchw')),
    ('pooling', ('pool', 'Pool')),
    ('B6 sgd_mom', ('sgd_mom_kernel',)),
    ('GEMM (Dense)', ('gemm', 'Gemm', 'GEMM')),
)


def resnet_breakdown(torch, prof, wall_ms):
    """Split one profiled ResNet-50 train step's kernel time by group: the
    convolutions (cuDNN), pooling, the Dense layer's GEMMs, B6, and the
    rest (BatchNorm's plain ops, ReLU, adds, the loss: elementwise work and
    reductions). Returns the kernel ms and the ms by group."""
    from torch.autograd import DeviceType
    busy = kernel_breakdown('resnet', 'train step (SGD-momentum, profiled; '
                            'host ms of the unprofiled step before)', prof,
                            wall_ms, top=15)
    names = [g for g, _ in RESNET_GROUPS] + [
        'BatchNorm, ReLU and other elementwise work and reductions']
    sums, counts = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        g = next((g for g, keys in RESNET_GROUPS
                  if any(k in e.key for k in keys)), names[-1])
        sums[g] += e.self_device_time_total / 1e3
        counts[g] += e.count
    log('[resnet] kernel ms of the step by group: ' + ', '.join(
        f'{g} {ms:.2f} ({100 * ms / max(busy, 1e-9):.1f} %, x{counts[g]})'
        for g, ms in sums.items()))
    return dict(busy_ms=busy, wall_ms=wall_ms, groups=sums)


def resnet_costs(torch, got):
    """Log the resnet phase's numbers, eager and graphed, against the
    step's bound."""
    flops = 3 * RESNET50_FWD_FLOPS * RESNET_BATCH
    bound_ms, _ = bound(0, flops)
    for tag, run in got['runs'].items():
        step = run['loop_ms'] / RESNET_STEPS
        b = run['breakdown']
        log(f'[resnet] {tag}: a step {step:.2f} host ms back to back, '
            f'{run["img_s"]:.1f} img/s ({run["fed_img_s"]:.1f} host-fed); '
            f'{flops / 1e9:.0f} GFLOP (3 x {RESNET50_FWD_FLOPS / 1e9:.2f} x '
            f'{RESNET_BATCH}) at the fp32 CUDA-core peak of '
            f'{FP32_OPS_S / 1e12:.0f} TFLOP/s is {bound_ms:.2f} ms, a '
            f'ceiling of {RESNET_BATCH / bound_ms * 1e3:.0f} img/s: the step '
            f'is {100 * bound_ms / step:.1f} % of its bound '
            f'({flops / step / 1e9:.1f} TFLOP/s); busy '
            f'{100 * b["busy_ms"] / b["wall_ms"]:.0f} % of the profiled step '
            f'({b["busy_ms"]:.2f} kernel ms over {b["wall_ms"]:.2f} host '
            f'ms); peak memory above the run\'s start {run["peak"][0]:.2f} '
            f'GiB allocated, {run["peak"][1]:.2f} GiB reserved')
    k = got['kstep']
    log(f'[resnet] K-step loop over pure_function: {k["img_s"]:.1f} img/s '
        f'({k["ms"] / RESNET_K:.2f} ms a step); graphed predict '
        f'{got["graph_ms"][-1]:.2f} host ms against eager '
        f'{got["eager_ms"][-1]:.2f}; card {smi_line()}')


def resnet_parity(torch, seed, steps=2):
    """A ``resnet18_v1(classes=10, thumbnail=True)`` trains ``steps``
    SGD-momentum steps on a (4, 3, 32, 32) batch on the card (cuDNN) and
    on the CPU from the same weights. The losses must agree at rtol 1e-4,
    and each weight's and running statistic's change over the steps on the
    card must be within 1 % of that tensor's change on the CPU, in the
    2-norm: the two-step change is what training computes, and two fp32
    libraries' orders of summation (a weight gradient sums over every
    position of the batch) part by more than 1e-5 of a weight where that
    change is large."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = np.array([1, 7, 3, 9], np.float32)
    losses, state, weights = {}, {}, None
    for where in (mx.cpu(), mx.gpu(0)):
        with where:
            mx.random.seed(seed)
            net = vision.resnet18_v1(classes=10, thumbnail=True)
            net.initialize(ctx=where)
            xs, ys = mx.np.array(x), mx.np.array(y)
            net(xs)                     # deferred initialization
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                net.load_dict(weights)
            net.hybridize()
            trainer = gluon.Trainer(net.collect_params(), RESNET_OPT[0],
                                    dict(RESNET_OPT[1]))
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            losses[str(where)] = [
                resnet_step(mx, net, trainer, loss_fn, xs, ys).item()
                for _ in range(steps)]
            state[str(where)] = {k: p.data().asnumpy().astype(np.float64)
                                 for k, p in net.collect_params().items()}
    cpu, card = losses['cpu(0)'], losses['gpu(0)']
    ok = all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(card, cpu))
    rel = {}
    for k, w0 in weights.items():
        step_cpu = state['cpu(0)'][k] - w0
        step_card = state['gpu(0)'][k] - w0
        rel[k] = float(np.linalg.norm(step_card - step_cpu)
                       / max(np.linalg.norm(step_cpu), 1e-30))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    absd = max(float(np.abs(state['gpu(0)'][k] - state['cpu(0)'][k]).max())
               for k in rel)
    bad = sorted(k for k, r in rel.items() if not r <= 1e-2)
    log(f'[resnet] resnet18_v1 thumbnail (10 classes, (4, 3, 32, 32)), '
        f'{steps} SGD-momentum steps: losses on the card {card}, on the CPU '
        f'{cpu} (rtol 1e-4); {len(rel)} weights and running statistics: '
        f'max |card - CPU| {absd:.3g}; |card\'s change - CPU\'s change| over '
        f'|CPU\'s change| (2-norms over the steps), worst '
        f'{[(k, float(f"{r:.3g}")) for k, r in worst]} (1e-2) -> '
        f'{"ok" if ok and not bad else "MISMATCH"}')
    if not ok or bad:
        fail(f'resnet: the card and the CPU train resnet18 apart: losses '
             f'{card} against {cpu}; tensors past tolerance {bad}')


# ------------------------------------------------------------- bf16
#: the bf16 phase follows ``bench.py --dtype bf16`` (bench.py:1084, the
#: reference's default): build, initialize, one forward, ``cast
#: ('bfloat16')``, then hybridize. llama3_8b's causal forward takes one
#: seeded batch of this many tokens; generate() a prompt of BF16_PROMPT
#: tokens and BF16_NEW new ones
BF16_TOKENS = 2048
BF16_PROMPT, BF16_NEW = 32, 32
#: the bf16 losses (from fp32 logits) are held across runs at this
#: relative tolerance: the logits are bf16 values (2**-7 of one an ulp at
#: most), and two runs that round their products and sums in other places
#: part by an ulp or two
BF16_LOSS_RTOL = 1e-2
#: card against CPU in bf16: the change of all the weights over the steps
#: within this share of the CPU's change (the CPU tests hold the port to
#: the JAX package at 0.15 for Adam and 0.1 for SGD, where 0.057 and 0.023
#: were seen)
BF16_CHANGE_GAP = 0.15
#: seeds of the bf16 resnet18 card-against-CPU check (about 4.5 s each):
#: two correct runs part by 0.05-6.4 % at a second step, so one seed
#: shows little; eight show the spread
BF16_RESNET_SEEDS = 8
#: Adam's learning rate for bf16 BERT: at the bert phase's 1e-4 a step is
#: below half a bf16 ulp of most weights and rounds away
BF16_BERT_LR = 1e-3


def _bf16_still(what, still, allowed):
    """Fail unless the tensors a bf16 run left unchanged are among
    ``allowed`` (names, or suffixes after a dot): a norm's gamma of 1.0
    moves only by a step of 2**-8 or more (half its bf16 ulp)."""
    bad = [k for k in still if k not in allowed
           and not any(k.endswith('.' + a) for a in allowed)]
    if bad:
        fail(f'bf16 {what}: {bad} did not move')


def _dtype_events(prof, parts=('fused_norm', 'flash_fwd', 'paged_decode')):
    """``{kernel: {element type: events}}`` of a profiled window for the
    kernels whose names hold ``parts``, by the kernel template's first
    argument (the element type of x, or of q: ``float`` or
    ``__nv_bfloat16``), so that a run shows the dtype each launch took."""
    from torch.autograd import DeviceType
    out = {p: {} for p in parts}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        part = next((p for p in parts if p in e.key), None)
        if part is None:
            continue
        first = e.key.split('<', 1)[1].split(',', 1)[0] if '<' in e.key \
            else ''
        dt = 'bf16' if 'bfloat16' in first else 'fp32' if 'float' in first \
            else first
        out[part][dt] = out[part].get(dt, 0) + e.count
    return out


def _plain_since(kernels, before):
    after = kernels.plain_update_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _bf16_dtypes(what, params, want='bfloat16'):
    got = sorted({str(p.data().dtype) for p in params.values()})
    if got != [want]:
        fail(f'bf16: {what} holds {got} after cast(\'bfloat16\')')


def _bf16_slots(what, trainer):
    """The Trainer's slots of bf16 weights: fp32, as the JAX Trainer's
    fp32 device scalars leave them after its first update."""
    dts = sorted({str(t.dtype) for st in trainer._states.values()
                  for t in (st if isinstance(st, (list, tuple)) else [st])
                  if t is not None})
    if dts != ['torch.float32']:
        fail(f'bf16: {what} slots {dts}, want float32')


def phase_bf16(torch, seed):
    """BERT-base, ResNet-50 and llama3_8b in bf16 on the card: see the
    module docstring. Returns what :func:`bf16_costs` logs."""
    got = dict(bert=_bf16_bert(torch, seed))
    torch.cuda.empty_cache()
    got['resnet'] = _bf16_resnet(torch, seed + 1)
    torch.cuda.empty_cache()
    got['llama'] = _bf16_llama(torch, seed + 2)
    torch.cuda.empty_cache()
    return got


def _bf16_bert(torch, seed):
    """bert_12_768_12 at (32, 128) cast to bf16, BERT_STEPS Adam steps
    eagerly and then graphed from the same weights: 26 B1 and 12 B2 launches
    a step, all bf16 (the profiled step's kernel names), no B5 and
    BERT_UPDATED plain updates a step, fp32 slots."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    dev = mx.gpu(0).to_torch()
    mx.random.seed(seed)
    net = bert.bert_12_768_12(max_length=BERT_SEQ, dropout=0.0,
                              use_classifier=False)
    net.initialize(ctx=mx.gpu(0))
    ids, tt, labels = bert_batch(mx, seed, BERT_BATCH, BERT_SEQ, BERT_VOCAB)
    net(ids, tt)                        # deferred initialization, fp32
    net.cast('bfloat16')
    params = net.collect_params()
    _bf16_dtypes('bert', params)
    init = {k: p.data()._data.detach().clone() for k, p in params.items()}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    want = dict(BERT_FORWARD)
    runs, steps, busy, peaks, groups = {}, {}, {}, {}, {}
    for graphed in (False, True):
        tag = 'graphed' if graphed else 'eager'
        for k, p in params.items():
            p.set_data(init[k])
        net.hybridize(graphed, static_alloc=True)
        mem = _memory_start(torch, dev)
        trainer = gluon.Trainer(params, 'adam',
                                {'learning_rate': BF16_BERT_LR})
        losses, wall = [], []

        def step():
            loss = bert_step(mx, net, trainer, loss_fn, ids, tt, labels)
            _sync(torch, dev)
            return loss

        for i in range(BERT_STEPS):
            last = i == BERT_STEPS - 1
            if last:
                rewind = Rewind(torch, trainer)
                plain0 = kernels.plain_update_counts()
                prof, loss, ms, got = profile_checked(
                    torch, f'bf16 bert {tag} Adam step', step,
                    lambda: (rewind(), plain0.update(
                        kernels.plain_update_counts())))
                wall.append(ms)
            else:
                before = kernels.launch_counts()
                plain0 = kernels.plain_update_counts()
                _sync(torch, dev)
                t1 = time.perf_counter()
                loss = step()
                wall.append((time.perf_counter() - t1) * 1e3)
                got = _counts_since(kernels, before)
            losses.append(float(loss.item()))
            plain = _plain_since(kernels, plain0)
            if got != want or plain != {'adam': BERT_UPDATED}:
                fail(f'bf16 bert: {tag} step {i + 1} launched {got} and '
                     f'{plain} plain updates, want {want} and '
                     f'{ {"adam": BERT_UPDATED} }')
            if last:
                log(f'[bf16] bert {tag} Adam step profiled:')
                groups[tag] = bert_breakdown(torch, prof, wall[-2])
                busy[tag] = _busy_share(prof, wall[-2])
                dts = _dtype_events(prof)
                log(f'[bf16] bert {tag}: kernel launches by element type '
                    f'{dts}')
                if dts['fused_norm'] != {'bf16': 26} or \
                        dts['flash_fwd'] != {'bf16': 12}:
                    fail(f'bf16 bert: the norm and flash launches of a step '
                         f'were not all bf16: {dts}')
            del loss
        _bf16_slots(f'bert {tag}', trainer)
        state = {k: p.data()._data.detach().clone()
                 for k, p in params.items()}
        runs[graphed] = (losses, state)
        moved = [k for k in params if not torch.equal(state[k], init[k])]
        still = sorted(set(params) - set(moved))
        log(f'[bf16] bert {tag} Adam (lr {BF16_BERT_LR}): losses {losses}; '
            f'host ms a step '
            f'{[round(w, 2) for w in wall]} (the last profiled); '
            f'{BERT_BATCH / wall[-2] * 1e3:.1f} samples/s at step '
            f'{BERT_STEPS - 1}; launches a step {want} and '
            f'{BERT_UPDATED} plain updates; unchanged: {still}')
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            fail(f'bf16 bert: {tag} losses not finite or not falling: '
                 f'{losses}')
        _bf16_still(f'bert {tag}', still, ('pooler.bias', 'pooler.weight',
                                           'gamma'))
        steps[tag] = wall
        peaks[tag] = _memory_peaks(torch, dev, mem)
        if graphed:
            graph_counts(net, trainer, 'bf16 bert', want_captures=2)
        _bf16_dtypes(f'bert after {tag} training', params)
        del trainer
    (el, _), (gl, _) = runs[False], runs[True]
    ok = all(math.isclose(a, b, rel_tol=BF16_LOSS_RTOL)
             for a, b in zip(gl, el))
    _, worst = _change_gaps(init, runs)
    log(f'[bf16] bert graphed against eager from the same weights: losses '
        f'{gl} and {el} (rtol {BF16_LOSS_RTOL}); |graphed change - eager '
        f'change| over |eager change|, worst {worst} (logged) -> '
        f'{"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('bf16 bert: the graphed steps train apart from the eager ones')
    del net, init, runs
    return dict(steps=steps, busy=busy, peaks=peaks, groups=groups)


def _bf16_resnet(torch, seed):
    """resnet50_v1 at batch 32, 224, cast to bf16 (bench_resnet and
    bench_resnet_train): graphed predict, K forwards back to back; then
    graphed SGD-momentum steps (the logits cast to fp32 for the loss, as
    bench does), RESNET_UPDATED plain updates a step and no kernel; then
    the K-step loop over ``pure_function``."""
    from torch.autograd import DeviceType
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, io
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import kernels
    dev = mx.gpu(0).to_torch()
    mx.random.seed(seed)
    net = vision.resnet50_v1()
    net.initialize(ctx=mx.gpu(0))
    net(mx.np.ones((1, 3, 224, 224), ctx=mx.gpu(0)))
    net.cast('bfloat16')
    params = net.collect_params()
    _bf16_dtypes('resnet', params)
    images, labels = resnet_data(seed, RESNET_BATCH * RESNET_BATCHES)
    it = io.NDArrayIter(images, labels, batch_size=RESNET_BATCH,
                        shuffle=False)
    batches = [(b.data[0].astype('bfloat16').as_in_context(mx.gpu(0)),
                b.label[0].as_in_context(mx.gpu(0))) for b in it]
    x0, y0 = batches[0]
    with mx.autograd.predict_mode():
        eager = net(x0)
    net.hybridize(static_alloc=True)
    out = net(x0)                       # captures the predict graph
    err, ok = compare(torch, out._data, eager._data, 0.0, 0.0)
    if not ok or out.dtype != eager.dtype or str(out.dtype) != 'bfloat16':
        fail(f'bf16 resnet: graphed predict parts from the eager forward '
             f'({err:.3g}) or is not bf16 ({out.dtype})')
    k = RESNET_K
    before = kernels.launch_counts()
    _sync(torch, dev)
    t1 = time.perf_counter()
    for _ in range(k):
        out = net(x0)
    _sync(torch, dev)
    infer_ms = (time.perf_counter() - t1) * 1e3 / k
    # three calls, each in a profiler session of its own, checked against
    # the launch counters (ROADMAP C5); each session's kernel count is
    # logged, and a replay's device time by CUDA events stands beside the
    # profiler's kernel time
    prof = profiled_calls(torch, lambda: net(x0), 3,
                          'bf16 resnet50 graphed predict')
    infer_busy = kernel_breakdown('bf16', 'resnet50 graphed predict, batch '
                                  f'{RESNET_BATCH}, bf16', prof, infer_ms,
                                  reps=3, top=6)
    counts = [sum(e.count for e in p.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0) for p in prof.profs]
    infer_events = _events_ms(torch, lambda: net(x0), k)
    log(f'[bf16] resnet graphed predict: kernels in each profiled call '
        f'{counts}; device ms a call by CUDA events over {k} calls '
        f'{infer_events:.2f}')
    log(f'[bf16] resnet graphed predict: {k} forwards back to back '
        f'{infer_ms:.2f} ms a forward, {RESNET_BATCH / infer_ms * 1e3:.1f} '
        f'img/s; launches {_counts_since(kernels, before)}; equal to the '
        f'eager forward ({err:.3g})')
    del out, eager

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    init = {k_: p.data()._data.detach().clone() for k_, p in params.items()}
    mem = _memory_start(torch, dev)
    trainer = gluon.Trainer(params, RESNET_OPT[0], dict(RESNET_OPT[1]))
    losses, wall, prof = [], [], None
    n = RESNET_WARMUP + RESNET_STEPS
    for i in range(n):
        x, y = batches[i % len(batches)]

        def step():
            loss = resnet_step(mx, net, trainer, loss_fn, x, y)
            _sync(torch, dev)
            return loss

        plain0 = kernels.plain_update_counts()
        if i == n - 1:  # a retry is one more step: nothing compares after
            prof, loss, ms, got = profile_checked(
                torch, 'bf16 resnet graphed step', step,
                lambda: plain0.update(kernels.plain_update_counts()))
            wall.append(ms)
        else:
            before = kernels.launch_counts()
            _sync(torch, dev)
            t1 = time.perf_counter()
            loss = step()
            wall.append((time.perf_counter() - t1) * 1e3)
            got = _counts_since(kernels, before)
        losses.append(float(loss.item()))
        plain = _plain_since(kernels, plain0)
        if got or plain != {'sgd_mom': RESNET_UPDATED}:
            fail(f'bf16 resnet: step {i + 1} launched {got} and {plain} '
                 f'plain updates, want none and '
                 f'{ {"sgd_mom": RESNET_UPDATED} }')
    _sync(torch, dev)
    t1 = time.perf_counter()
    for i in range(RESNET_STEPS):
        loss = resnet_step(mx, net, trainer, loss_fn,
                           *batches[i % len(batches)])
    loop_loss = loss.item()
    loop_ms = (time.perf_counter() - t1) * 1e3 / RESNET_STEPS
    log(f'[bf16] resnet graphed SGD-momentum {RESNET_OPT[1]}: losses '
        f'{losses}; host ms a step synced one by one '
        f'{[round(w, 2) for w in wall]} (the last profiled); '
        f'{RESNET_STEPS} steps back to back {loop_ms:.2f} ms a step, '
        f'{RESNET_BATCH / loop_ms * 1e3:.1f} img/s, last loss {loop_loss}; '
        f'{RESNET_UPDATED} plain updates a step, no kernel')
    log('[bf16] resnet graphed step profiled:')
    breakdown = resnet_breakdown(torch, prof, wall[-2])
    if not all(math.isfinite(v) for v in losses + [loop_loss]):
        fail(f'bf16 resnet: losses not finite: {losses}')
    still = sorted(k_ for k_, p in params.items()
                   if torch.equal(p.data()._data, init[k_]))
    log(f'[bf16] resnet: unchanged over the steps: {still}')
    _bf16_still('resnet', still, ('gamma',))
    graph_counts(net, trainer, 'bf16 resnet', want_captures=3)
    _bf16_slots('resnet', trainer)
    _bf16_dtypes('resnet after training', params)
    peak = _memory_peaks(torch, dev, mem)
    del trainer, init
    kstep = resnet_kstep(torch, net, x0, dev)
    del net, batches
    return dict(infer_ms=infer_ms, infer_busy=infer_busy,
                infer_events=infer_events, loop_ms=loop_ms,
                wall=wall, breakdown=breakdown, peak=peak, kstep=kstep)


def _bf16_llama(torch, seed):
    """llama3_8b at full width and depth, seeded fp32 weights cast to bf16
    (16 GB): first one causal (1, BF16_TOKENS) forward in fp32, then the
    same in bf16 (65 B1 in RMS mode and 32 B2 launches, all bf16 by their
    kernel names; finite logits), generate() from a BF16_PROMPT-token
    prompt (BF16_NEW new tokens), and the generated tokens teacher-forced
    through the forward."""
    from mxnet_tpu_torch.ops import kernels
    net = build_llama('llama3_8b', seed)
    cfg, dev = net.cfg, _device(net)
    toks = torch.randint(0, cfg.vocab_size, (1, BF16_TOKENS),
                         generator=torch.Generator().manual_seed(seed))
    toks = toks.to(dev)
    want = _want(fused_norm=2 * cfg.num_layers + 1,
                 flash_attention=cfg.num_layers)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        if dtype == torch.bfloat16:
            net.cast('bfloat16')
            torch.cuda.empty_cache()
        mem = _memory_start(torch, dev)
        before = kernels.launch_counts()
        with torch.no_grad():
            logits = net(toks)          # the first call: warm-up
            _sync(torch, dev)
            t1 = time.perf_counter()
            logits = _t(net(toks))
            _sync(torch, dev)
            ms = (time.perf_counter() - t1) * 1e3
            launched = _counts_since(kernels, before)

            def forward():
                net(toks)
                _sync(torch, dev)

            prof, _, _, profiled_launches = profile_checked(
                torch, f'bf16 llama3_8b {tag} forward', forward)
        got = {k: v // 2 for k, v in launched.items()}
        if profiled_launches != got:
            fail(f'bf16 llama3_8b {tag}: the profiled forward launched '
                 f'{profiled_launches}, the others {got} each')
        dts = _dtype_events(prof)
        log(f'[bf16] llama3_8b {tag} causal (1, {BF16_TOKENS}) forward: '
            f'{ms:.2f} host ms, {BF16_TOKENS / ms * 1e3:.1f} tok/s, logits '
            f'{tuple(logits.shape)} {logits.dtype}; launches a forward '
            f'{got}; by element type {dts}')
        busy = kernel_breakdown('bf16', f'llama3_8b {tag} forward', prof, ms,
                                top=6)
        b1 = sum(e.self_device_time_total for e in prof.key_averages()
                 if 'fused_norm' in e.key) / 1e3
        b2 = sum(e.self_device_time_total for e in prof.key_averages()
                 if 'flash_fwd' in e.key) / 1e3
        want_dt = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        if got != {k: v for k, v in want.items() if v} or \
                dts['fused_norm'] != {want_dt: want['fused_norm']} or \
                dts['flash_fwd'] != {want_dt: want['flash_attention']}:
            fail(f'bf16 llama: {tag} forward launched {got} ({dts}), want '
                 f'{want}, all {want_dt}')
        if logits.dtype != dtype or \
                not bool(torch.isfinite(logits.float()).all()):
            fail(f'bf16 llama: {tag} logits {logits.dtype} or not finite')
        res[tag] = dict(ms=ms, busy_ms=busy, b1_ms=b1, b2_ms=b2,
                        peak=_memory_peaks(torch, dev, mem))
        del logits, prof
    prompt = torch.randint(1, cfg.vocab_size, (1, BF16_PROMPT),
                           generator=torch.Generator().manual_seed(seed + 1))
    prompt = prompt.to(dev)
    net.generate(prompt, max_new_tokens=BF16_NEW)        # captures
    before = kernels.launch_counts()
    _sync(torch, dev)
    t1 = time.perf_counter()
    out = net.generate(prompt, max_new_tokens=BF16_NEW)
    _sync(torch, dev)
    gen_ms = (time.perf_counter() - t1) * 1e3
    launches = _counts_since(kernels, before)
    new = out[0, BF16_PROMPT:].tolist()
    log(f'[bf16] llama3_8b bf16 generate(): {BF16_NEW} tokens from a '
        f'{BF16_PROMPT}-token prompt in {gen_ms:.2f} ms, '
        f'{BF16_NEW / gen_ms * 1e3:.1f} tok/s (one eager prefill, the '
        f'decode steps replayed from a graph over the fp32 dense cache); '
        f'launches {launches}; tokens {new}')
    if launches != {'fused_norm': want['fused_norm'] * BF16_NEW}:
        fail(f'bf16 llama: generate() launched {launches}, want '
             f'{ {"fused_norm": want["fused_norm"] * BF16_NEW} }')
    # the tokens teacher-forced through the flash forward: the two paths
    # round bf16 in other places, so only positions whose top-2 logit
    # margin exceeds 0.25 (a few bf16 ulps of a logit) are held
    seq = out[:, :-1]
    logits = _t(net(seq))[0, BF16_PROMPT - 1:].float()
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    pick = logits.argmax(-1).tolist()
    clear = [i for i, m in enumerate(margin) if m > 0.25]
    bad = [i for i in clear if pick[i] != new[i]]
    log(f'[bf16] llama3_8b teacher-forced check over {len(new)} tokens: '
        f'{len(clear)} with margin > 0.25, {len(bad)} disagree; '
        f'{sum(p == o for p, o in zip(pick, new))} of {len(new)} equal')
    if bad:
        fail(f'bf16 llama: teacher-forced argmax differs at {bad}')
    res['generate'] = dict(ms=gen_ms, tok_s=BF16_NEW / gen_ms * 1e3)
    net.release_graphs()
    del net, logits, out
    return res


def _weights_gap(got, want, start):
    """|got change - want change| over |want change| from ``start``, one
    vector of every tensor (dicts of float64 CPU tensors)."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in start)
    den = sum(float(((want[k] - w0) ** 2).sum()) for k, w0 in start.items())
    return (num / den) ** 0.5


def _host_weights(net):
    return {k: p.data()._data.detach().double().cpu()
            for k, p in net.collect_params().items()}


def bf16_parity(torch, seed):
    """A small BERT (two Adam steps) and a ``resnet18_v1`` thumbnail (two
    SGD-momentum steps), each cast to bf16 after its first forward, train
    on the card and on the CPU from the same weights. Held: the losses at
    BF16_LOSS_RTOL, and the change of all the weights together within
    BF16_CHANGE_GAP of the CPU's (|card change - CPU change| over |CPU
    change|, one vector of every tensor): bf16 gradients part by rounding
    noise, which a BatchNorm over four images and Adam's per-element
    normalisation amplify in single elements. For the resnet see
    :func:`_bf16_parity_resnet18`, run for BF16_RESNET_SEEDS seeds from
    ``seed``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    steps = 2
    losses, state, weights, start = {}, {}, None, None
    for where in (mx.cpu(), mx.gpu(0)):
        with where:
            mx.random.seed(seed)
            net = bert.get_bert_model(
                'bert_12_768_12', vocab_size=1000, num_layers=2, units=128,
                hidden_size=512, num_heads=2, max_length=32, dropout=0.0,
                use_classifier=False)
            batch = bert_batch(mx, seed, 4, 32, 1000)
            net.initialize(ctx=where)
            net(*batch[:2])
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                net.load_dict(weights)
            net.cast('bfloat16')
            if start is None:
                start = _host_weights(net)
            net.hybridize()
            trainer = gluon.Trainer(net.collect_params(), 'adam',
                                    {'learning_rate': BF16_BERT_LR})
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            losses[str(where)] = [
                float(bert_step(mx, net, trainer, loss_fn, *batch).item())
                for _ in range(steps)]
            state[str(where)] = _host_weights(net)
    cpu, card = losses['cpu(0)'], losses['gpu(0)']
    gap = _weights_gap(state['gpu(0)'], state['cpu(0)'], start)
    ok = all(math.isclose(a, b, rel_tol=BF16_LOSS_RTOL)
             for a, b in zip(card, cpu)) and gap <= BF16_CHANGE_GAP
    log(f'[bf16] bert, bf16, {steps} adam steps: losses on the card {card}, '
        f'on the CPU {cpu} (rtol {BF16_LOSS_RTOL}); |card change - CPU '
        f'change| over |CPU change| of all the weights {gap:.4f} '
        f'({BF16_CHANGE_GAP}) -> {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('bf16: the card and the CPU train the small bert apart')
    for s in range(seed, seed + BF16_RESNET_SEEDS):
        _bf16_parity_resnet18(torch, s)


def _bf16_parity_resnet18(torch, seed):
    """A ``resnet18_v1`` thumbnail (four 32 x 32 images, RESNET_OPT) cast
    to bf16 trains two steps on the CPU and on the card from the same
    weights. Held: each step's loss at BF16_LOSS_RTOL and the weights'
    change within BF16_CHANGE_GAP of the CPU's, (a) after step 1 and after
    step 2 of the two free-running runs (the second loss only logged),
    and (b) over a second step that the card takes from the CPU's state
    after its first (weights, running statistics, momenta, update count).
    Why the free-running second loss is not held: two correct runs part
    there by more than BF16_LOSS_RTOL. The JAX package and the port, both
    on the CPU, part by 0.05-6.4 % at step 2 over eight seeds in bf16
    (0.00-0.09 % in fp32), where their weights' change after two steps
    stays within 0.065-0.076 (``tests/torch_bf16_witness.py``): a bf16
    step moves a weight by whole ulps or not at all, and a BatchNorm over
    four images amplifies it. Step (b) starts both from one state, so its
    loss is held as the first step's is."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    yr = np.array([1, 7, 3, 9], np.float32)
    run, weights, start = {}, None, None
    for tag, where in (('cpu', mx.cpu()), ('card', mx.gpu(0))):
        with where:
            mx.random.seed(seed)
            net = vision.resnet18_v1(classes=10, thumbnail=True)
            net.initialize(ctx=where)
            net(mx.np.array(xr))
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                net.load_dict(weights)
            net.cast('bfloat16')
            if start is None:
                start = _host_weights(net)
            net.hybridize()
            trainer = gluon.Trainer(net.collect_params(), RESNET_OPT[0],
                                    dict(RESNET_OPT[1]))
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            x, y = mx.np.array(xr).astype('bfloat16'), mx.np.array(yr)
            r = run[tag] = dict(net=net, trainer=trainer)
            r['loss1'] = float(resnet_step(mx, net, trainer, loss_fn, x,
                                           y).item())
            r['w1'] = _host_weights(net)
            r['trainer1'] = trainer.state_dict()
            r['loss2'] = float(resnet_step(mx, net, trainer, loss_fn, x,
                                           y).item())
            r['w2'] = _host_weights(net)
    cpu, card = run['cpu'], run['card']
    # (b): the card's net and trainer take the CPU's state after step 1
    dev = mx.gpu(0).to_torch()
    with torch.no_grad():
        for k, p in card['net'].collect_params().items():
            p.data()._data.copy_(cpu['w1'][k].to(dev))
    card['trainer'].load_state_dict(cpu['trainer1'])
    with mx.gpu(0):
        loss2b = float(resnet_step(
            mx, card['net'], card['trainer'],
            gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.np.array(xr).astype('bfloat16'), mx.np.array(yr)).item())
    w2b = _host_weights(card['net'])
    gaps = [_weights_gap(card['w1'], cpu['w1'], start),
            _weights_gap(card['w2'], cpu['w2'], start),
            _weights_gap(w2b, cpu['w2'], cpu['w1'])]
    ok = math.isclose(card['loss1'], cpu['loss1'], rel_tol=BF16_LOSS_RTOL) \
        and math.isclose(loss2b, cpu['loss2'], rel_tol=BF16_LOSS_RTOL) \
        and max(gaps) <= BF16_CHANGE_GAP
    log(f'[bf16] resnet18 seed {seed}, bf16, sgd: losses on the CPU '
        f'{[cpu["loss1"], cpu["loss2"]]}, on the card '
        f'{[card["loss1"], card["loss2"]]} (step 1 at rtol {BF16_LOSS_RTOL}; '
        f'step 2 logged, {abs(card["loss2"] - cpu["loss2"]) / cpu["loss2"]:.4f}'
        f' apart), step 2 from the CPU\'s step-1 state {loss2b} '
        f'({abs(loss2b - cpu["loss2"]) / cpu["loss2"]:.4f} apart, rtol '
        f'{BF16_LOSS_RTOL}); |card change - CPU change| over |CPU change| '
        f'of all the weights after step 1 {gaps[0]:.4f}, after step 2 '
        f'{gaps[1]:.4f}, over step 2 from the CPU\'s state {gaps[2]:.4f} '
        f'({BF16_CHANGE_GAP}) -> {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail(f'bf16: the card and the CPU train the small resnet18 apart '
             f'(seed {seed})')


def bf16_costs(torch, got, fp32):
    """Each bf16 path beside the fp32 run of the same path in this process
    (the bert, resnet phases; the llama forward of this phase): host ms a
    step or call, busy share, samples/s, img/s or tok/s, peak memory
    (allocated, reserved) and kernel ms by group."""
    def pct(x):
        return f'{100 * x:.1f} %'
    b, fb = got['bert'], fp32.get('bert')
    for tag in ('eager', 'graphed'):
        step = b['steps'][tag][-2]
        line = (f'[bf16] compare bert {tag} Adam step: bf16 {step:.2f} host '
                f'ms, {BERT_BATCH / step * 1e3:.1f} samples/s, busy '
                f'{pct(b["busy"][tag])}, peak {b["peaks"][tag][0]:.2f} / '
                f'{b["peaks"][tag][1]:.2f} GiB, kernel ms by group '
                f'{ {g: round(v, 2) for g, v in b["groups"][tag].items()} }')
        if fb:
            fs = (fb['graphed_steps'] if tag == 'graphed'
                  else fb['steps'])['adam'][-2]
            groups = {g: round(v, 2) for g, v in fb['groups'][tag].items()}
            line += (f'; fp32 {fs:.2f} host ms, '
                     f'{BERT_BATCH / fs * 1e3:.1f} samples/s, busy '
                     f'{pct(fb["busy"][tag])}, peak '
                     f'{fb["peaks"][tag][0]:.2f} / {fb["peaks"][tag][1]:.2f} '
                     f'GiB, kernel ms by group {groups}')
        else:
            line += '; fp32 not run in this process'
        log(line)
    r, fr = got['resnet'], fp32.get('resnet')
    bd = r['breakdown']
    line = (f'[bf16] compare resnet50 graphed SGD-momentum step: bf16 '
            f'{r["loop_ms"]:.2f} ms back to back, '
            f'{RESNET_BATCH / r["loop_ms"] * 1e3:.1f} img/s, busy '
            f'{pct(bd["busy_ms"] / bd["wall_ms"])}, peak {r["peak"][0]:.2f} '
            f'/ {r["peak"][1]:.2f} GiB, kernel ms by group '
            f'{ {g: round(v, 2) for g, v in bd["groups"].items()} }; K-step '
            f'loop {r["kstep"]["img_s"]:.1f} img/s; graphed predict '
            f'{r["infer_ms"]:.2f} ms a forward '
            f'({RESNET_BATCH / r["infer_ms"] * 1e3:.1f} img/s, '
            f'{r["infer_busy"]:.2f} kernel ms, {r["infer_events"]:.2f} device '
            f'ms by CUDA events)')
    if fr:
        g = fr['runs']['graphed']
        gb = g['breakdown']
        line += (f'; fp32 {g["loop_ms"] / RESNET_STEPS:.2f} ms, '
                 f'{g["img_s"]:.1f} img/s, busy '
                 f'{pct(gb["busy_ms"] / gb["wall_ms"])}, peak '
                 f'{g["peak"][0]:.2f} / {g["peak"][1]:.2f} GiB, kernel ms by '
                 f'group {({k: round(v, 2) for k, v in gb["groups"].items()})}'
                 f'; K-step {fr["kstep"]["img_s"]:.1f} img/s; graphed predict '
                 f'{fr["graph_ms"][-1]:.2f} host ms (one call)')
    else:
        line += '; fp32 not run in this process'
    log(line)
    ll = got['llama']
    for tag in ('fp32', 'bf16'):
        x = ll[tag]
        log(f'[bf16] compare llama3_8b (1, {BF16_TOKENS}) forward {tag}: '
            f'{x["ms"]:.2f} host ms, {BF16_TOKENS / x["ms"] * 1e3:.1f} '
            f'tok/s, busy {pct(x["busy_ms"] / x["ms"])}, B1 {x["b1_ms"]:.3f} '
            f'ms (65), B2 {x["b2_ms"]:.3f} ms (32), peak {x["peak"][0]:.2f} '
            f'/ {x["peak"][1]:.2f} GiB')
    log(f'[bf16] llama3_8b bf16 generate(): '
        f'{ll["generate"]["tok_s"]:.1f} tok/s; card {smi_line()}')


# ------------------------------------------------------------- qresnet
#: qresnet phase: bench_resnet_int8 (bench.py:745-800): resnet50_v1 at
#: full width and depth, fp32, seeded; quantized with naive calibration on
#: one seeded batch of QRESNET_CALIB images at 224 (the bench's constant
#: 0.5 would give every layer the range of one pixel value); graphed
#: predict at RESNET_BATCH, and the K-step loop over pure_function
QRESNET_CALIB = 8
#: B7 launches a forward of the int8 resnet50_v1: its 53 convolutions (one
#: group each, one launch over the gathered windows) and the output Dense
QRESNET_B7 = 54
#: the int8 resnet18 thumbnail card against CPU: the logits within this
#: share of the CPU's largest. The two float paths (cuDNN, the CPU)
#: round BatchNorm's and the convolutions' fp32 outputs in other places;
#: an input one ulp from a code's .5 boundary takes the next code, and 20
#: int8 layers compound such moves (the CPU test holds the port to the JAX
#: package at the same share, where 0.018 was seen)
QRESNET_LOGIT_TOL = 0.05
#: kernel groups of a ResNet-50 predict, int8 or float, matched on the
#: kernel's name in order
QRESNET_GROUPS = (
    ('B7 int8_matmul (int8 convolutions, Dense)', ('int8_',)),
    ('cuDNN convolutions', ('fprop', 'Fprop', 'implicit_convolve', 'conv2d',
                            'convolve', 'xmma', 'cudnn')),
    ('conv layout transforms', ('nchwToNhwc', 'nhwcToNchw', 'NchwToNhwc',
                                'NhwcToNchw')),
    ('pooling', ('pool', 'Pool')),
    ('quantize (divide, round, clamp)', ('round', 'clamp', 'DivFunctor',
                                         'div_true')),
    ('copies (window gathers, int8 casts, pads)', ('copy', 'Copy',
                                                   'CatArray', 'pad')),
    ('GEMM (float Dense)', ('gemm', 'Gemm', 'GEMM')),
)


def qresnet_breakdown(tag, what, prof, wall_ms, reps):
    """Split ``reps`` profiled predict calls' kernel time by
    :data:`QRESNET_GROUPS` (the rest: BatchNorm, ReLU, the residual adds
    and other elementwise work). Returns the kernel ms a call and the ms
    by group."""
    from torch.autograd import DeviceType
    busy = kernel_breakdown('qresnet', what, prof, wall_ms, reps=reps,
                            top=8)
    names = [g for g, _ in QRESNET_GROUPS] + [
        'BatchNorm, ReLU, adds and other elementwise work']
    sums, counts = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        g = next((g for g, keys in QRESNET_GROUPS
                  if any(k in e.key for k in keys)), names[-1])
        sums[g] += e.self_device_time_total / 1e3 / reps
        counts[g] += e.count // reps
    log(f'[{tag}] kernel ms a call by group: ' + ', '.join(
        f'{g} {ms:.3f} ({100 * ms / max(busy, 1e-9):.1f} %, x{counts[g]})'
        for g, ms in sums.items() if counts[g]))
    return dict(busy_ms=busy, groups=sums)


def _predict_costs(torch, net, x, dev, tag, want, k=RESNET_K):
    """A hybridized net's graphed predict on ``x``: the capture (the first
    call), ``k`` calls back to back on the host clock with exactly
    ``want`` launches each, three profiled calls (kernel ms by group, the
    busy share), the device ms a call by CUDA events, and peak memory
    above the start."""
    from mxnet_tpu_torch.ops import kernels
    mem = _memory_start(torch, dev)
    out = net(x)                        # captures the predict graph
    before = kernels.launch_counts()
    _sync(torch, dev)
    t1 = time.perf_counter()
    for _ in range(k):
        out = net(x)
    _sync(torch, dev)
    ms = (time.perf_counter() - t1) * 1e3 / k
    got = _counts_since(kernels, before)
    if got != {n: c * k for n, c in want.items()}:
        fail(f'qresnet: {tag} graphed predict launched {got} over {k} '
             f'calls, want {want} a call')
    prof = profiled_calls(torch, lambda: net(x), 3,
                          f'qresnet {tag} graphed predict')
    b = qresnet_breakdown('qresnet', f'resnet50_v1 {tag} graphed predict, '
                          f'batch {x.shape[0]}', prof, ms, reps=3)
    events = _events_ms(torch, lambda: net(x), k)
    peak = _memory_peaks(torch, dev, mem)
    log(f'[qresnet] {tag} graphed predict: {ms:.3f} host ms a call over {k} '
        f'back to back, {x.shape[0] / ms * 1e3:.1f} img/s; device ms a call '
        f'by CUDA events {events:.3f}; busy {100 * b["busy_ms"] / ms:.0f} %; '
        f'launches a call {want or "none"}; peak above the start '
        f'{peak[0]:.2f} GiB allocated, {peak[1]:.2f} GiB reserved; card '
        f'{smi_line()}')
    return dict(ms=ms, img_s=x.shape[0] / ms * 1e3, events_ms=events,
                busy=b['busy_ms'] / ms, groups=b['groups'], peak=peak,
                out=out)


def phase_qresnet(torch, seed):
    """ResNet-50 quantized to int8 through the port's Gluon quantization
    and predicted on ``mx.gpu(0)``: see the module docstring. Returns what
    :func:`qresnet_costs` logs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import quantization as q
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import kernels
    dev = mx.gpu(0).to_torch()
    mx.random.seed(seed)
    net = vision.resnet50_v1()
    net.initialize(ctx=mx.gpu(0))
    images, _ = resnet_data(seed, RESNET_BATCH + QRESNET_CALIB)
    x = mx.np.array(images[:RESNET_BATCH], ctx=mx.gpu(0))
    calib = mx.np.array(images[RESNET_BATCH:], ctx=mx.gpu(0))
    net(calib)                          # deferred initialization
    weights = {k_: p.data() for k_, p in net.collect_params().items()}
    with mx.autograd.predict_mode():
        float_logits = net(x)._data.clone()
    costs = {}
    net.hybridize(static_alloc=True)
    costs['fp32'] = _predict_costs(torch, net, x, dev, 'fp32', {})
    half = vision.resnet50_v1()
    half.initialize(ctx=mx.gpu(0))
    half(calib)
    half.load_dict(weights)
    half.cast('bfloat16')
    half.hybridize(static_alloc=True)
    costs['bf16'] = _predict_costs(torch, half, x.astype('bfloat16'), dev,
                                   'bf16', {})
    del half, weights
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    qnet = q.quantize_net(net, calib_data=[calib], calib_mode='naive')
    _sync(torch, dev)
    calib_s = time.perf_counter() - t0
    kinds = [type(c).__name__ for _, _, _, c in q._gluon_walk(qnet)]
    n_conv = kinds.count('QuantizedConv2D')
    log(f'[qresnet] quantize_net(resnet50_v1, naive, one seeded batch of '
        f'{QRESNET_CALIB} at 224) in {calib_s:.1f} s: {n_conv} '
        f'QuantizedConv2D, output {type(qnet.output).__name__}, float '
        f'Conv2D/Dense left {kinds.count("Conv2D") + kinds.count("Dense")}'
        f'; {sum(str(p.data().dtype) == "int8" for p in qnet.collect_params().values())} '
        f'int8 parameters')
    if qnet is not net or n_conv != 53 or 'Conv2D' in kinds or \
            'Dense' in kinds or \
            not isinstance(qnet.output, q.QuantizedDense):
        fail('qresnet: quantize_net did not swap the 53 convolutions and '
             'the output Dense')
    want = {'int8_matmul': QRESNET_B7}
    before = kernels.launch_counts()
    eager = qnet(x)
    if _counts_since(kernels, before) != want:
        fail(f'qresnet: an eager int8 forward launched '
             f'{_counts_since(kernels, before)}, want {want}')
    qnet.hybridize(static_alloc=True)
    costs['int8'] = _predict_costs(torch, qnet, x, dev, 'int8', want)
    out = costs['int8'].pop('out')
    for c in costs.values():
        c.pop('out', None)
    same = torch.equal(out._data, eager._data)
    top1 = float((out._data.float().argmax(-1) == float_logits.argmax(-1))
                 .float().mean())
    log(f'[qresnet] int8 graphed predict against the eager int8 forward: '
        f'{"bit-equal" if same else "DIFFERS"}; logits {out.dtype}; top-1 '
        f'of the int8 net against the float net on batch 0: {top1:.3f} '
        f'(a random net: its classes are near ties); captures '
        f'{qnet.capture_count}, cache keys {qnet.compile_count}')
    if not same or str(out.dtype) != 'bfloat16' or \
            (qnet.capture_count, qnet.compile_count) != (1, 1):
        fail('qresnet: the graphed int8 predict parts from the eager one, '
             'is not bf16, or captured again')
    kloop = qresnet_kloop(torch, qnet, x, dev)
    del out, eager, qnet, net
    return dict(costs=costs, kloop=kloop, top1=top1, calib_s=calib_s)


def qresnet_kloop(torch, net, x, dev, k=RESNET_K):
    """bench_resnet_int8's device loop: ``k`` forwards over
    ``pure_function(x, train=False)``, the input ``x * (1 + 2**-6 * i) +
    acc * 1e-12`` (``i`` a counter on the card, ``acc`` the last call's
    first logit), one step captured and replayed ``k`` times with no host
    sync between, QRESNET_B7 B7 launches a step. Returns img/s."""
    from mxnet_tpu_torch import _graphs
    from mxnet_tpu_torch.ops import kernels
    fn, ins, mains, auxs = net.pure_function(x, train=False)
    st = dict(i=torch.zeros((), device=dev), acc=torch.zeros((), device=dev))

    def step():
        xi = ins[0] * (1.0 + 2.0 ** -6 * st['i']) + st['acc'] * 1e-12
        outs, _ = fn(None, (xi,), mains, auxs)
        st['acc'].copy_(outs[0][0, 0].float())
        st['i'].add_(1.0)

    graph = _graphs.StepGraph(step, dev)
    graph.capture()                 # its warm-up is step 0
    before = kernels.launch_counts()
    _sync(torch, dev)
    t1 = time.perf_counter()
    graph.replay(times=k)
    _sync(torch, dev)
    ms = (time.perf_counter() - t1) * 1e3
    got = _counts_since(kernels, before)
    acc, i = float(st['acc']), float(st['i'])
    img_s = k * x.shape[0] / ms * 1e3
    log(f'[qresnet] K-step predict loop over pure_function (K = {k}, one '
        f'captured forward replayed K times, no host sync between): '
        f'{ms:.2f} ms, {ms / k:.3f} ms a forward, {img_s:.1f} img/s; '
        f'launches {got}; last first logit {acc:.4f} after {i:.0f} steps; '
        f'card {smi_line()}')
    if got != {'int8_matmul': QRESNET_B7 * k} or not math.isfinite(acc) \
            or i != k + 1:
        fail('qresnet: the K-step loop launched other than QRESNET_B7 B7 '
             'a step, or did not run its steps')
    graph.release()
    return dict(ms=ms, img_s=img_s)


def qresnet_rows(torch):
    """B7 at the int8 ResNet-50's shapes against its plain version (bit-
    equal), timed beside its bound and ``torch._int_mm``: the output Dense
    (M 32, N 1000, K 2048, bf16 out + bias) and the 3 x 3 convolutions of
    the first stage as one product over their gathered windows (M 32 x 56
    x 56, N 64, K 576). Then that convolution through
    ``quantized_conv2d`` (gather and B7) against one float64 convolution
    of the codes, bit-equal, both timed. Outside the phase's window: these
    launches compare, they are not the main path's."""
    from mxnet_tpu_torch.ops import quantization_ops as qo
    from mxnet_tpu_torch.ops.kernels import int8_matmul as im
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    why = ('an exact int32 sum, then the plain version\'s rounded '
           'operations one for one')
    rows = []
    for m, n, k, has_bias, what in (
            (32, 1000, 2048, True, 'ResNet-50\'s output Dense'),
            (32 * 56 * 56, 64, 576, False, 'ResNet-50\'s first-stage 3 x 3 '
             'convolution, its gathered windows')):
        x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device=dev) * 1e-4 + 1e-6
        b = torch.randn(n, generator=gen, device=dev) if has_bias else None

        def lib(x=x, wt=w.t(), scale=scale, b=b):
            out = torch._int_mm(x, wt).float() * scale
            return (out if b is None else out + b).to(bf16)
        nbytes = m * k + n * k + 4 * n * (2 if has_bias else 1) + 2 * m * n
        rows.append(_case(
            torch, 'int8_matmul',
            f'M={m} N={n} K={k} bfloat16 out{" + bias" if has_bias else ""}'
            f' ({what})', im.int8_matmul(x, w, scale, b, bf16).float(),
            im.int8_matmul_plain(x, w, scale, b, bf16).float(), (0.0, 0.0),
            why, lambda: im.int8_matmul(x, w, scale, b, bf16),
            lambda: im.int8_matmul_plain(x, w, scale, b, bf16), nbytes,
            2 * m * n * k, lib, ops_s=INT8_OPS_S,
            path=im.plan(m, n, k, True, sms).path))
        del x, w
    xq = torch.randint(-127, 128, (RESNET_BATCH, 64, 56, 56), generator=gen,
                       device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (64, 64, 3, 3), generator=gen,
                       device=dev, dtype=torch.int8)
    scale = torch.rand(64, generator=gen, device=dev) * 1e-4 + 1e-6
    args = (xq, wq, scale, None, 'bfloat16', (1, 1), (1, 1), (1, 1), 1,
            'NCHW')
    got, want = qo.quantized_conv2d(*args), qo.quantized_conv2d_plain(*args)
    ms, plain_ms = cuda_ms(torch, lambda: qo.quantized_conv2d(*args)), \
        cuda_ms(torch, lambda: qo.quantized_conv2d_plain(*args))
    ok = torch.equal(got, want)
    log(f'[qresnet] quantized_conv2d (32, 64, 56, 56) 3 x 3, pad 1: gather '
        f'and B7 {ms:.4f} ms against one float64 cuDNN convolution of the '
        f'codes {plain_ms:.4f} ms; {"bit-equal" if ok else "MISMATCH"}')
    if not ok:
        fail('qresnet: the gathered int8 convolution parts from the float64 '
             'convolution of the codes')
    return rows


def qresnet_costs(torch, got):
    """Log the qresnet phase's numbers side by side."""
    c = got['costs']
    for tag in ('fp32', 'bf16', 'int8'):
        r = c[tag]
        log(f'[qresnet] {tag} graphed predict, batch {RESNET_BATCH}: '
            f'{r["img_s"]:.1f} img/s, {r["ms"]:.3f} host ms a call, '
            f'{r["events_ms"]:.3f} device ms, busy {100 * r["busy"]:.0f} %, '
            f'peak {r["peak"][0]:.2f} / {r["peak"][1]:.2f} GiB; kernel ms: '
            + ', '.join(f'{g} {ms:.3f}' for g, ms in r['groups'].items()
                        if ms))
    int8_conv = c['int8']['groups'][QRESNET_GROUPS[0][0]]
    log(f'[qresnet] the int8 convolutions (B7 over gathered windows, the '
        f'Dense included) {int8_conv:.3f} ms a forward, plus their copies '
        f'{c["int8"]["groups"][QRESNET_GROUPS[5][0]]:.3f}, against cuDNN\'s '
        f'{c["bf16"]["groups"][QRESNET_GROUPS[1][0]]:.3f} in bf16 and '
        f'{c["fp32"]["groups"][QRESNET_GROUPS[1][0]]:.3f} in fp32; K-step '
        f'loop {got["kloop"]["img_s"]:.1f} img/s; card {smi_line()}')


def qresnet_parity(torch, seed):
    """A ``resnet18_v1(classes=10, thumbnail=True)`` quantized on the card
    and on the CPU from the same weights and the same seeded calibration
    batch (4, 3, 32, 32): per-layer calibration ranges equal (rtol 1e-5:
    the two float forwards round in other places), int8 weights bit-equal,
    the logits on a second seeded batch within QRESNET_LOGIT_TOL of the
    CPU's largest; the int8 net's top-1 against the float net's on the
    card is logged."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import quantization as q
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.default_rng(seed)
    calib = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    x = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    got, weights = {}, None
    for where in (mx.cpu(), mx.gpu(0)):
        with where:
            mx.random.seed(seed)
            net = vision.resnet18_v1(classes=10, thumbnail=True)
            net.initialize(ctx=where)
            net(mx.np.array(calib))
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                net.load_dict(weights)
            float_logits = net(mx.np.array(x)).asnumpy()
            q.quantize_net(net, calib_data=[calib], calib_mode='naive')
            net.hybridize(static_alloc=True)
            net(mx.np.array(x))
            logits = net(mx.np.array(x)).astype('float32').asnumpy()
            got[str(where)] = dict(
                ranges={p: c.collected_range
                        for _, _, p, c in q._gluon_walk(net)
                        if hasattr(c, 'collected_range')},
                codes={k: p.data().asnumpy() for k, p in
                       net.collect_params().items()
                       if k.endswith('qweight')},
                logits=logits, float_logits=float_logits)
    cpu, card = got['cpu(0)'], got['gpu(0)']
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for p in cpu['ranges'] for a, b in zip(card['ranges'][p],
                                                     cpu['ranges'][p]))
    codes = all(np.array_equal(card['codes'][k], v)
                for k, v in cpu['codes'].items())
    gap = float(np.abs(card['logits'] - cpu['logits']).max()) / \
        float(np.abs(cpu['logits']).max())
    top1 = float((card['logits'].argmax(-1)
                  == card['float_logits'].argmax(-1)).mean())
    same_top1 = float((card['logits'].argmax(-1)
                       == cpu['logits'].argmax(-1)).mean())
    ok = set(card['ranges']) == set(cpu['ranges']) and rel <= 1e-5 and \
        codes and len(cpu['codes']) == 21 and gap <= QRESNET_LOGIT_TOL
    log(f'[qresnet] int8 resnet18_v1 thumbnail, card against CPU: '
        f'{len(cpu["ranges"])} calibration ranges, worst relative gap '
        f'{rel:.3g} (1e-5); {len(cpu["codes"])} int8 weights '
        f'{"bit-equal" if codes else "DIFFER"}; logits max gap over the '
        f'CPU\'s largest {gap:.4f} ({QRESNET_LOGIT_TOL}); top-1 card against '
        f'CPU {same_top1:.3f}, int8 against float on the card {top1:.3f} -> '
        f'{"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('qresnet: the card and the CPU quantize resnet18 apart')


# ------------------------------------------------------------- optim
#: optim phase: bert_12_768_12 at (32, 128) trains BERT_STEPS graphed steps
#: with each of these (Adam for the side-by-side, then AdamW and LAMB,
#: the optimizers BERT users train it with)
OPTIM_OPTS = (('adam', {'learning_rate': 1e-4}),
              ('adamw', {'learning_rate': 1e-4, 'wd': 0.01}),
              ('lamb', {'learning_rate': 1e-3, 'wd': 0.01}))
#: the small net every optimizer trains card against CPU, and its settings
OPTIM_PARITY = {
    'sgd': {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3},
    'nag': {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3},
    'adam': {'learning_rate': 0.01, 'wd': 1e-3},
    'adamw': {'learning_rate': 0.01, 'wd': 1e-2},
    'adamax': {'learning_rate': 0.01},
    'nadam': {'learning_rate': 0.01},
    'adagrad': {'learning_rate': 0.05},
    'adadelta': {'learning_rate': 1.0},
    'rmsprop': {'learning_rate': 0.01, 'centered': True},
    'ftrl': {'learning_rate': 0.1},
    'ftml': {'learning_rate': 0.01},
    'signum': {'learning_rate': 0.01},
    'sgld': {'learning_rate': 0.01},
    'dcasgd': {'learning_rate': 0.1, 'momentum': 0.9},
    'lars': {'learning_rate': 0.1},
    'lamb': {'learning_rate': 0.01, 'wd': 1e-2},
    'lans': {'learning_rate': 0.01},
}


def phase_optim(torch, seed):
    """BERT-base trained graphed with Adam, AdamW and LAMB on
    ``mx.gpu(0)``: see the module docstring. Returns what
    :func:`optim_costs` logs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    dev = mx.gpu(0).to_torch()
    mx.random.seed(seed)
    net = bert.bert_12_768_12(max_length=BERT_SEQ, dropout=0.0,
                              use_classifier=False)
    net.initialize(ctx=mx.gpu(0))
    ids, tt, labels = bert_batch(mx, seed, BERT_BATCH, BERT_SEQ, BERT_VOCAB)
    net(ids, tt)                    # deferred initialization
    params = net.collect_params()
    init = {k: p.data()._data.detach().clone() for k, p in params.items()}
    net.hybridize(static_alloc=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for opt, hyper in OPTIM_OPTS:
        for k, p in params.items():
            p.set_data(init[k])
        trainer = gluon.Trainer(params, opt, dict(hyper))
        want = dict(BERT_FORWARD, **({'adam': BERT_UPDATED}
                                     if opt == 'adam' else {}))
        losses, wall, update_ms, busy, groups = [], [], [], None, None

        def step():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with mx.autograd.record():
                _, _, mlm = net(ids, tt)
                loss = loss_fn(mlm, labels).mean()
            loss.backward()
            a.record()
            trainer.step(1)
            b.record()
            _sync(torch, dev)
            return loss, a.elapsed_time(b)

        for i in range(BERT_STEPS):
            last = i == BERT_STEPS - 1
            if last:
                prof, (loss, upd), ms, got = profile_checked(
                    torch, f'optim graphed {opt} step', step,
                    Rewind(torch, trainer))
                wall.append(ms)
            else:
                before = kernels.launch_counts()
                _sync(torch, dev)
                t1 = time.perf_counter()
                loss, upd = step()
                wall.append((time.perf_counter() - t1) * 1e3)
                got = _counts_since(kernels, before)
            update_ms.append(upd)
            losses.append(loss.item())
            if got != want:
                fail(f'optim: {opt} step {i + 1} launched {got}, want '
                     f'{want}')
            if last:
                log(f'[optim] graphed {opt} step profiled:')
                groups = bert_breakdown(torch, prof, wall[-2])
                busy = _busy_share(prof, wall[-2])
        log(f'[optim] graphed {opt} {hyper}: losses {losses}; host ms a '
            f'step {[round(w, 2) for w in wall]}; the update {[round(u, 3) for u in update_ms]} '
            f'device ms (CUDA events around Trainer.step, a replayed graph '
            f'after the first); launches a step {want}')
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            fail(f'optim: {opt} losses not finite or not falling: {losses}')
        graph_counts(net, trainer, f'optim {opt}', want_captures=2)
        runs[opt] = dict(wall=wall, update_ms=update_ms, busy=busy,
                         groups=groups, losses=losses)
        del trainer
    return dict(runs=runs)


def optim_costs(torch, got):
    """Log the optim phase's numbers, AdamW and LAMB beside Adam."""
    for opt, r in got['runs'].items():
        step = r['wall'][-2]
        log(f'[optim] BERT-base graphed {opt}: {step:.2f} host ms a step, '
            f'{BERT_BATCH / step * 1e3:.1f} samples/s, busy '
            f'{100 * r["busy"]:.1f} %, the update {r["update_ms"][-1]:.3f} '
            f'device ms a step (replayed); card {smi_line()}')


def optim_parity(torch, seed, steps=2):
    """Every optimizer trains a small net (Dense 64 -> tanh -> Dense 10,
    a seeded (16, 32) batch) ``steps`` steps on the card, its update a
    replayed graph, and on the CPU from the same weights: the losses
    within rtol 1e-4, and each tensor's change over the steps within 1 %
    of the CPU's (2-norm). SGLD's noise is each device's own draw: only
    its first loss is compared, and its weights must move and stay
    finite."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    y = rng.standard_normal((16, 10)).astype(np.float32)
    bad = []
    for opt, hyper in OPTIM_PARITY.items():
        losses, state, weights, captures = {}, {}, None, None
        for where in (mx.cpu(), mx.gpu(0)):
            with where:
                mx.random.seed(seed)
                net = nn.HybridSequential(
                    nn.Dense(64, in_units=32, activation='tanh'),
                    nn.Dense(10, in_units=64))
                net.initialize(ctx=where)
                if weights is None:
                    weights = {k: p.data().asnumpy()
                               for k, p in net.collect_params().items()}
                else:
                    net.load_dict(weights)
                trainer = gluon.Trainer(net.collect_params(), opt,
                                        dict(hyper))
                xs, ys = mx.np.array(x), mx.np.array(y)
                out = []
                for _ in range(steps):
                    with mx.autograd.record():
                        loss = ((net(xs) - ys) ** 2).mean()
                    loss.backward()
                    trainer.step(1)
                    out.append(loss.item())
                losses[str(where)] = out
                state[str(where)] = {k: p.data().asnumpy().astype(np.float64)
                                     for k, p in
                                     net.collect_params().items()}
                if where.device_type == 'gpu':
                    captures = trainer.capture_count
        cpu, card = losses['cpu(0)'], losses['gpu(0)']
        n = 1 if opt == 'sgld' else steps
        ok = all(math.isclose(a, b, rel_tol=1e-4)
                 for a, b in zip(card[:n], cpu[:n])) and captures == 1
        worst = 0.0
        for k, w0 in weights.items():
            d_cpu, d_card = state['cpu(0)'][k] - w0, state['gpu(0)'][k] - w0
            if opt == 'sgld':
                ok = ok and np.isfinite(d_card).all() and \
                    np.abs(d_card).max() > 0
                continue
            r = float(np.linalg.norm(d_card - d_cpu)
                      / max(np.linalg.norm(d_cpu), 1e-30))
            worst = max(worst, r)
            ok = ok and r <= 1e-2
        log(f'[optim] {opt} {hyper}, {steps} steps card against CPU: '
            f'losses {card} and {cpu}; worst change gap {worst:.3g} (1e-2); '
            f'update graphs captured on the card {captures} -> '
            f'{"ok" if ok else "MISMATCH"}')
        if not ok:
            bad.append(opt)
    if bad:
        fail(f'optim: the card and the CPU train apart with {bad}')


# ------------------------------------------------------------- dist
#: the dist phase: bench_kvstore's replica reduce (bench.py:661-698, a
#: 200 MB uniform key set of 50 keys, 4 replicas), BERT-base over two
#: ranks (BERT_BATCH sequences in all, half a rank), the 2-bit keys and
#: the SyncBatchNorm thumbnail's batch
DIST_RANKS = 2
#: (b) and (c) train BERT-base's widths at this many of its 12 layers (cut
#: to keep the run inside its time limit, as elastic, sharding and
#: dist_async are)
DIST_LAYERS = 4
DIST_KEYS, DIST_KEY_ELEMS, DIST_REPLICAS = 50, 1_000_000, 4
DIST_STEPS = BERT_STEPS
DIST_GC_SHAPES = ((1000,), (64, 33), (7,))
DIST_BN_BATCH = 8


def _digests(torch, tensors):
    """One int a tensor that two tensors share only if their bits are
    equal (a weighted sum of the 32-bit words, mod 2**64)."""
    out = []
    for t in tensors:
        w = t.detach().contiguous().view(-1).view(torch.int32).long()
        mult = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append(int((w * mult).sum()))
    return out


def dist_reduce(torch):
    """(a) The ``device`` kvstore's replica reduce at bench_kvstore's shape
    on cuda:0: ``fused_pushpull`` of 50 keys of 1 M fp32 values, 4
    replicas each, into one out tensor a key. Returns the device ms, the
    bound and the worst error against a float64 sum."""
    from mxnet_tpu_torch import kvstore
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    vals = [[torch.rand(DIST_KEY_ELEMS, generator=gen, device='cuda') * 2 - 1
             for _ in range(DIST_REPLICAS)] for _ in range(DIST_KEYS)]
    outs = [torch.empty(DIST_KEY_ELEMS, device='cuda')
            for _ in range(DIST_KEYS)]
    kv = kvstore.create('device')
    keys = list(range(DIST_KEYS))

    def call():
        kv.fused_pushpull(keys, vals, outs=[[o] for o in outs],
                          priorities=[-k for k in keys])

    call()
    torch.cuda.synchronize()
    worst = 0.0
    for vs, o in zip(vals, outs):
        want = sum(v.double() for v in vs)
        worst = max(worst, float((o.double() - want).abs().max()
                                 / want.abs().max()))
    ms = cuda_ms(torch, call)
    nbytes = (DIST_REPLICAS + 1) * DIST_KEYS * DIST_KEY_ELEMS * 4
    bound_ms, _ = bound(nbytes, 3 * DIST_KEYS * DIST_KEY_ELEMS)
    log(f'[dist] (a) device kvstore fused_pushpull, {DIST_KEYS} keys x '
        f'{DIST_KEY_ELEMS * 4 / 1e6:.0f} MB x {DIST_REPLICAS} replicas on '
        f'cuda:0: {ms:.4f} ms device (one call in a CUDA graph), '
        f'{nbytes / ms / 1e6:.1f} GB/s of the {nbytes / 1e9:.1f} GB the sum '
        f'must move (4 replicas read, one out written); bound {bound_ms:.4f} '
        f'ms at {HBM_BYTES_S / 1e12:.2f} TB/s; plain PyTorch reads each '
        f'replica once but reads and writes the out three times (1.8 GB); '
        f'max |sum - float64 sum| / max |float64 sum| {worst:.3g} (1e-6); '
        f'card {smi_line()}')
    if not worst <= 1e-6:
        fail(f'dist: the replica sum is off the float64 sum by {worst}')
    del vals, outs
    torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=bound_ms, nbytes=nbytes)


def _dist_bert(torch, mx, gluon, net, params, init, ids, tt, labels, zero1,
               rank):
    """(b) or (c) in one rank: DIST_STEPS Adam steps of BERT-base on this
    rank's half of the batch through ``Trainer(kvstore='dist_sync')``,
    from ``init``; ``zero1`` sets ``update_on_kvstore``. Host ms a step
    split into forward and backward, the all-reduce (with its staging)
    and the update (CUDA events around it for its device ms); the launch
    counts a step and the weights' digests after each."""
    import torch.distributed as dist
    from mxnet_tpu_torch.ops import kernels
    for k, p in params.items():
        p.set_data(init[k])
    trainer = gluon.Trainer(params, 'adam', dict(BERT_OPTS[0][2]),
                            kvstore='dist_sync', update_on_kvstore=zero1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    dev = mx.gpu(0).to_torch()
    res = dict(losses=[], split=[], update_ms=[], counts=[], digests=[])

    def step():
        t0 = time.perf_counter()
        with mx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).mean()
        loss.backward()
        _sync(torch, dev)
        t1 = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if zero1:
            t2 = t1
            a.record()
            trainer.step(1)
            b.record()
        else:
            trainer.allreduce_grads()
            _sync(torch, dev)
            t2 = time.perf_counter()
            a.record()
            trainer.update(1)
            b.record()
        _sync(torch, dev)
        t3 = time.perf_counter()
        return loss, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3), \
            a.elapsed_time(b)

    def plain_step():
        before = kernels.launch_counts()
        _sync(torch, dev)
        out = step()
        return out, _counts_since(kernels, before)

    for i in range(DIST_STEPS):
        dist.barrier()
        profile = i == DIST_STEPS - 1 and not zero1
        if not profile:
            out, counts = plain_step()
        else:
            # rank 0's step is profiled and checked; when its profile lost
            # events every rank runs the step again from its start (the
            # all-reduce needs them all), at most PROFILE_TRIES times
            rewind = Rewind(torch, trainer)
            for n in range(1, PROFILE_TRIES + 1):
                if rank == 0:
                    prof, out, _, counts, short = profile_once(
                        torch, '(b) dist_sync rank 0 step', step)
                else:
                    (out, counts), short = plain_step(), {}
                again = [short]
                dist.broadcast_object_list(again, src=0)
                if not again[0]:
                    break
                if n == PROFILE_TRIES:
                    fail(f'dist: all {n} profiler sessions of rank 0\'s '
                         f'step lost kernel events; the last: {again[0]}')
                rewind()
                dist.barrier()
        loss, split, upd = out
        res['split'].append(split)
        res['update_ms'].append(upd)
        res['losses'].append(loss.item())
        res['counts'].append(counts)
        res['digests'].append(_digests(torch, [p.data()._data
                                               for p in params.values()]))
        if profile and rank == 0:
            res['busy'] = _busy_share(prof, sum(res['split'][-2]))
    res['graphs'] = (net.capture_count, trainer.capture_count,
                     net.eager_call_count)
    res['nbytes'] = sum(4 * math.prod(p.shape) for p in params.values())
    return res


def _dist_gc(torch, seed, rank):
    """(d) A 2-bit compressed pushpull of DIST_GC_SHAPES keys over the
    ranks on cuda:0: this rank's words against the CPU's, and the sums
    against the decode-sum of every rank's words made on the CPU."""
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.kvstore.gradient_compression import \
        GradientCompression
    params = {'type': '2bit', 'threshold': 0.5}

    def grads(r):
        gen = torch.Generator().manual_seed(seed + r)
        return [torch.randn(*s, generator=gen) for s in DIST_GC_SHAPES]

    mine = [g.cuda() for g in grads(rank)]
    gpu_gc, cpu_gc = GradientCompression(), GradientCompression()
    gpu_gc.set_params(params)
    cpu_gc.set_params(params)
    words_equal = all(torch.equal(gpu_gc.quantize(i, g).cpu(),
                                  cpu_gc.quantize(i, g.cpu()))
                      for i, g in enumerate(mine))
    want = []
    for i, s in enumerate(DIST_GC_SHAPES):
        total = torch.zeros(s)
        for r in range(DIST_RANKS):
            gc = GradientCompression()
            gc.set_params(params)
            total += gc.dequantize(gc.quantize(i, grads(r)[i]), s)
        want.append(total)
    kv = kvstore.create('dist_tpu_sync')
    kv.set_gradient_compression(params)
    outs = [torch.empty_like(g) for g in mine]
    kv.pushpull(list(range(len(mine))), mine, out=outs)
    sums_equal = all(torch.equal(o.cpu(), w) for o, w in zip(outs, want))
    return dict(words_equal=words_equal, sums_equal=sums_equal)


def _bn_thumbnail(mx, vision, sync):
    """resnet18_v1's thumbnail with SyncBatchNorm (``sync``) or BatchNorm
    layers."""
    from unittest import mock
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    with mock.patch.object(resnet, 'BatchNorm',
                           nn.SyncBatchNorm if sync else nn.BatchNorm):
        return vision.resnet18_v1(classes=10, thumbnail=True)


def _bn_data(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((DIST_BN_BATCH, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, DIST_BN_BATCH).astype(np.float32)
    return x, y


def _bn_step(mx, gluon, vision, seed, sync, rows):
    """One recorded forward and backward of the thumbnail on ``rows`` of
    the batch, hybridized, from the seed's weights; the loss is the sum
    over the rows. Returns the logits, every gradient and the running
    statistics (on the host) and the eager calls."""
    x, y = _bn_data(seed)
    mx.random.seed(seed)
    net = _bn_thumbnail(mx, vision, sync)
    net.initialize(ctx=mx.gpu(0))
    xs, ys = mx.np.array(x[rows]), mx.np.array(y[rows])
    net(xs)                 # deferred initialization, predict mode
    net.hybridize()
    with mx.autograd.record():
        out = net(xs)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, ys).sum()
    loss.backward()
    params = net.collect_params()
    return dict(out=out._data.cpu(), eager=net.eager_call_count,
                grads={k: p.grad()._data.cpu() for k, p in params.items()
                       if p.grad_req != 'null'},
                stats={k: p.data()._data.cpu() for k, p in params.items()
                       if p.grad_req == 'null'})


def _bn_layer(mx, nn, seed, sync, rows):
    """One BatchNorm (``sync``: SyncBatchNorm) layer in training mode on
    ``rows`` of a seeded (8, 64, 16, 16) batch, the loss the sum of its
    output times a seeded cotangent: the output, the input's gradient,
    gamma's and beta's gradients and the running statistics."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((DIST_BN_BATCH, 64, 16, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    layer = (nn.SyncBatchNorm if sync else nn.BatchNorm)(in_channels=64)
    layer.initialize(ctx=mx.gpu(0))
    layer.gamma.set_data(mx.np.array(1 + 0.1 * w[0, :, 0, 0]))
    layer.beta.set_data(mx.np.array(0.1 * w[1, :, 0, 0]))
    xs = mx.np.array(x[rows])
    xs.attach_grad()
    with mx.autograd.record():
        out = layer(xs)
        loss = (out * mx.np.array(w[rows])).sum()
    loss.backward()
    return {'out': out._data.cpu(), 'dx': xs.grad._data.cpu(),
            ('g', 'gamma'): layer.gamma.grad()._data.cpu(),
            ('g', 'beta'): layer.beta.grad()._data.cpu(),
            ('s', 'mean'): layer.running_mean.data()._data.cpu(),
            ('s', 'var'): layer.running_var.data()._data.cpu()}


def _dist_rank(seed):
    """One rank of the dist phase (run by ``parallel.launch.spawn``; the
    ranks share cuda:0 over gloo): (b) and (c), each counted from 0 just
    before and read just after, then (d) and (e)."""
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert, vision
    from mxnet_tpu_torch.ops import kernels
    full_fp32(torch)        # as the parent, whose references the ranks meet
    rank = dist.get_rank()
    half = BERT_BATCH // DIST_RANKS
    rows = slice(rank * half, (rank + 1) * half)
    mx.random.seed(seed)
    net = bert.bert_12_768_12(max_length=BERT_SEQ, dropout=0.0,
                              use_classifier=False, num_layers=DIST_LAYERS)
    net.initialize(ctx=mx.gpu(0))
    ids, tt, labels = (a[rows] for a in bert_batch(
        mx, seed, BERT_BATCH, BERT_SEQ, BERT_VOCAB))
    net(ids, tt)                    # deferred initialization
    params = net.collect_params()
    init = {k: p.data()._data.detach().clone() for k, p in params.items()}
    net.hybridize(static_alloc=True)
    dev = mx.gpu(0).to_torch()
    res = {'rank': rank}
    for zero1 in (False, True):
        mem = _memory_start(torch, dev)
        kernels.reset_launch_counts()           # the main path starts
        run = _dist_bert(torch, mx, gluon, net, params, init, ids, tt,
                         labels, zero1, rank)
        run['launches'] = kernels.launch_counts()   # ... and ends
        run['designs'] = kernels.path_counts()
        run['peak'] = _memory_peaks(torch, dev, mem)
        res['zero1' if zero1 else 'dp'] = run
        if not zero1:
            dp_state = {k: p.data()._data.detach().clone()
                        for k, p in params.items()}
            if rank == 0:
                res['state'] = {k: t.cpu() for k, t in dp_state.items()}
                res['init'] = {k: t.cpu() for k, t in init.items()}
    gaps = [float((p.data()._data - dp_state[k]).double().norm()
                  / max(float(dp_state[k].double().norm()), 1e-30))
            for k, p in params.items()]
    res['zero1_gap'] = max(gaps)
    del net, params, init, dp_state
    torch.cuda.empty_cache()
    res['profiles'] = list(PROFILES)
    res['gc'] = _dist_gc(torch, seed + 1, rank)
    half = DIST_BN_BATCH // DIST_RANKS
    rows = slice(rank * half, (rank + 1) * half)
    res['bn_layer'] = _bn_layer(mx, gluon.nn, seed + 2, True, rows)
    res['bn'] = _bn_step(mx, gluon, vision, seed + 2, True, rows)
    dist.barrier()
    return res


def phase_dist(torch, seed):
    """Data-parallel training over ``torch.distributed``: see the module
    docstring. (a) runs here, the rest in ``DIST_RANKS`` ranks that share
    cuda:0 over gloo (NCCL refuses two ranks on one card); then the
    one-process references. Returns the ranks' summed launch counts of
    (b) and (c), in all and by design."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert, vision
    from mxnet_tpu_torch.parallel import launch
    got = {'reduce': dist_reduce(torch)}
    t0 = time.perf_counter()
    ranks = launch.spawn(_dist_rank, DIST_RANKS, seed, backend='gloo',
                         timeout=600)
    log(f'[dist] {DIST_RANKS} ranks on cuda:0 over gloo in '
        f'{time.perf_counter() - t0:.1f} s (spawn included)')
    counts, by_design = dict.fromkeys(KERNELS, 0), {}
    want_dp = bert_launches(DIST_LAYERS)
    forward = {k: v for k, v in want_dp.items() if k != 'adam'}
    updated = want_dp['adam']
    for r in ranks:
        PROFILES.extend(r['profiles'])
        for run in ('dp', 'zero1'):
            for name, c in r[run]['launches'].items():
                counts[name] += c
            for name, ds in r[run]['designs'].items():
                for d, c in ds.items():
                    by_design.setdefault(name, {}).setdefault(d, 0)
                    by_design[name][d] += c
        if any(c != want_dp for c in r['dp']['counts']):
            fail(f'dist: rank {r["rank"]} (b) launched {r["dp"]["counts"]} '
                 f'a step, want {want_dp}')
        if any({k: v for k, v in c.items() if k != 'adam'} != forward
               for c in r['zero1']['counts']):
            fail(f'dist: rank {r["rank"]} (c) launched '
                 f'{r["zero1"]["counts"]} a step')
        if r['dp']['graphs'] != (2, 1, 0) or \
                r['zero1']['graphs'][0] != 2 or r['zero1']['graphs'][2]:
            fail(f'dist: rank {r["rank"]} graphs (net, Trainer, eager '
                 f'recorded calls) (b) {r["dp"]["graphs"]}, (c) '
                 f'{r["zero1"]["graphs"]}: want (2, 1, 0) and (2, 0, 0)')
    owned = [sum(c.get('adam', 0) for c in zip_c)
             for zip_c in zip(*(r['zero1']['counts'] for r in ranks))]
    if owned != [updated] * DIST_STEPS:
        fail(f'dist: (c) B5 launches summed over the ranks {owned} a step, '
             f'want {updated}')
    for run in ('dp', 'zero1'):
        digests = [r[run]['digests'] for r in ranks]
        if any(d != digests[0] for d in digests):
            fail(f'dist: ({"b" if run == "dp" else "c"}) the ranks\' weights '
                 f'are not bit-equal after every step')
    gap = max(r['zero1_gap'] for r in ranks)
    log(f'[dist] (b) and (c): every rank {want_dp} a step in (b); (c) B5 '
        f'launches by rank a step {[[c.get("adam", 0) for c in r["zero1"]["counts"]] for r in ranks]} '
        f'(sum {updated}: each key on its owner); the ranks\' weights '
        f'bit-equal after every step in both; (c) against (b) after '
        f'{DIST_STEPS} steps: worst |w_c - w_b| / |w_b| {gap:.3g} (1e-6); '
        f'no collective in a captured graph (the transport refuses to run '
        f'in a capture), graphs a rank (net, Trainer, eager recorded calls) '
        f'(b) {ranks[0]["dp"]["graphs"]}, (c) {ranks[0]["zero1"]["graphs"]}')
    if not gap <= 1e-6:
        fail(f'dist: the ZeRO-1 weights part from (b)\'s by {gap}')
    got['ranks'] = [{k: v for k, v in r.items()
                     if k not in ('state', 'init')} for r in ranks]
    dist_one_process(torch, mx, gluon, bert, seed, ranks)
    for r in ranks:
        if not (r['gc']['words_equal'] and r['gc']['sums_equal']):
            fail(f'dist: (d) rank {r["rank"]}: 2-bit words equal the CPU\'s '
                 f'{r["gc"]["words_equal"]}, sums exact '
                 f'{r["gc"]["sums_equal"]}')
    log(f'[dist] (d) 2-bit pushpull of {list(DIST_GC_SHAPES)} over '
        f'{DIST_RANKS} ranks on cuda:0: every rank\'s words bit-equal to '
        f'the CPU\'s, every sum equal to the CPU\'s decode-sum of the '
        f'ranks\' words -> ok')
    dist_sync_bn(torch, mx, gluon, vision, seed + 2, ranks)
    return counts, by_design, got


def dist_one_process(torch, mx, gluon, bert, seed, ranks):
    """(b) against one process: the same BERT_BATCH sequences from the same
    weights through ``kvstore='device'`` and ``step(1 / DIST_RANKS)``: the
    ranks' mean losses are means over half the batch, which the kvstore
    sums, so that rescale gives the same function. Losses at rtol 1e-4,
    each tensor's change over the steps within 1 % (2-norm), as the bert
    phase holds the card against the CPU."""
    mx.random.seed(seed)
    net = bert.bert_12_768_12(max_length=BERT_SEQ, dropout=0.0,
                              use_classifier=False, num_layers=DIST_LAYERS)
    net.initialize(ctx=mx.gpu(0))
    ids, tt, labels = bert_batch(mx, seed, BERT_BATCH, BERT_SEQ, BERT_VOCAB)
    net(ids, tt)
    params = net.collect_params()
    init = ranks[0]['init']
    for k, p in params.items():
        p.set_data(init[k].cuda())
    net.hybridize(static_alloc=True)
    trainer = gluon.Trainer(params, 'adam', dict(BERT_OPTS[0][2]),
                            kvstore='device')
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(DIST_STEPS):
        with mx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).mean()
        loss.backward()
        trainer.step(1 / DIST_RANKS)
        losses.append(loss.item())
    state = {k: p.data()._data.detach().cpu() for k, p in params.items()}
    ranked = [sum(r['dp']['losses'][i] for r in ranks) / DIST_RANKS
              for i in range(DIST_STEPS)]
    ok = all(math.isclose(a, b, rel_tol=1e-4)
             for a, b in zip(ranked, losses))
    bad, worst = _change_gaps(init, {False: (losses, state),
                                     True: (ranked, ranks[0]['state'])})
    log(f'[dist] (b) {DIST_RANKS} ranks against one process over the same '
        f'{BERT_BATCH} sequences (kvstore device, step(1/{DIST_RANKS})): '
        f'losses {ranked} and {losses} (rtol 1e-4); |ranks\' change - one '
        f'process\'s change| over |one process\'s change|, worst {worst} '
        f'(1e-2) -> {"ok" if ok and not bad else "MISMATCH"}')
    if not ok or bad:
        fail(f'dist: two ranks train BERT-base apart from one process: '
             f'losses {ranked} against {losses}; past tolerance {bad}')
    del net, params, trainer, state
    torch.cuda.empty_cache()


def _bn_gaps(torch, got, want, rtol=1e-4):
    """``got`` against ``want`` (dicts of tensors), each at ``rtol`` and
    an atol of ``rtol`` of its largest entry; returns the keys past it
    and the worst max error over max |want|."""
    bad, worst = [], 0.0
    for k, w in want.items():
        top = max(float(w.abs().max()), 1e-30)
        err, ok = compare(torch, got[k], w, rtol, rtol * top)
        worst = max(worst, err / top)
        if not ok:
            bad.append(k)
    return bad, worst


def dist_sync_bn(torch, mx, gluon, vision, seed, ranks):
    """(e) SyncBatchNorm over the two ranks against one process's
    BatchNorm over the whole batch. One layer alone: its output, its
    input's gradient, gamma's and beta's gradients (the ranks' summed, as
    the kvstore sums them) and the running statistics at rtol 1e-4 with
    an atol of 1e-4 of each tensor's largest entry. The resnet18 thumbnail
    (19 SyncBatchNorm layers): its logits and running statistics at the
    same tolerance, and each gradient, summed over the ranks, within 1 %
    of the one-process gradient in the 2-norm, the rule
    :func:`resnet_parity` holds two fp32 runs to: the ranks' convolutions
    run at batch 4 and the reference's at 8, whose fp32 sums part in the
    last bits, and a ReLU whose input sits within those bits of 0 passes
    its gradient on one side only, so single gradient entries of a ReLU
    net part by more than 1e-4 of the largest (one card run saw 3.8 %,
    where the same step on the CPU parts by 2.5e-6). Each rank's recorded
    call ran eagerly (its collectives cannot be captured) and was
    counted."""
    from mxnet_tpu_torch.gluon import nn
    layers = [r['bn_layer'] for r in ranks]
    want = _bn_layer(mx, nn, seed, False, slice(None))
    got = {k: (torch.cat([b[k] for b in layers]) if k in ('out', 'dx')
               else sum(b[k] for b in layers) if k[0] == 'g'
               else layers[0][k]) for k in want}
    bad_layer, worst_layer = _bn_gaps(torch, got, want)
    bns = [r['bn'] for r in ranks]
    want = _bn_step(mx, gluon, vision, seed, False, slice(None))
    ref = {'out': want['out']}
    ref.update({('s', k): v for k, v in want['stats'].items()})
    got = {'out': torch.cat([b['out'] for b in bns])}
    got.update({('s', k): bns[0]['stats'][k] for k in want['stats']})
    bad_net, worst_net = _bn_gaps(torch, got, ref)
    grad_gap, grad_abs = {}, 0.0
    for k, w in want['grads'].items():
        g = sum(b['grads'][k] for b in bns).double()
        grad_gap[k] = float((g - w.double()).norm()
                            / max(float(w.double().norm()), 1e-30))
        grad_abs = max(grad_abs, float((g - w.double()).abs().max()
                                       / max(float(w.abs().max()), 1e-30)))
    bad_net += sorted(k for k, r in grad_gap.items() if not r <= 1e-2)
    worst = sorted(grad_gap.items(), key=lambda kv: -kv[1])[:3]
    eager = [b['eager'] for b in bns]
    ok = not bad_layer and not bad_net and eager == [1] * DIST_RANKS
    log(f'[dist] (e) SyncBatchNorm over {DIST_RANKS} ranks against one '
        f'process\'s BatchNorm over {DIST_BN_BATCH} images: one layer, '
        f'(8, 64, 16, 16): output, input gradient, gamma and beta gradients '
        f'and running statistics, worst max err / max |want| '
        f'{worst_layer:.3g} (rtol 1e-4, atol 1e-4 of the largest); the '
        f'resnet18 thumbnail: logits and {len(want["stats"])} running '
        f'statistics {worst_net:.3g} (the same), {len(want["grads"])} '
        f'gradients, |ranks\' sum - one process| over |one process| '
        f'(2-norm), worst {[(k, float(f"{r:.3g}")) for k, r in worst]} '
        f'(1e-2; max err over max |want| {grad_abs:.3g}); recorded calls '
        f'run eagerly by rank {eager} -> {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail(f'dist: SyncBatchNorm over two ranks parts from BatchNorm over '
             f'the batch: the layer at {bad_layer}, the thumbnail at '
             f'{bad_net[:5]}; eager calls {eager}')


def dist_costs(torch, got):
    """Log the dist phase's numbers beside the card's name and limit."""
    card = smi_line()
    for r in got['ranks']:
        for run, tag in (('dp', '(b) dist_sync'), ('zero1', '(c) ZeRO-1')):
            x = r[run]
            fwd, red, upd = x['split'][-2]
            step = fwd + red + upd
            log(f'[dist] {tag} rank {r["rank"]}: host ms a step '
                f'{step:.2f} = forward+backward {fwd:.2f} + all-reduce '
                f'{red:.2f} (staging included) + update {upd:.2f} (step '
                f'{DIST_STEPS - 1}; all steps {[[round(v, 2) for v in s] for s in x["split"]]}); '
                f'update device ms {[round(u, 3) for u in x["update_ms"]]}; '
                f'{x["nbytes"] / 1e6:.1f} MB reduced a step; '
                f'{BERT_BATCH / step * 1e3:.1f} samples/s over both ranks; '
                f'busy {100 * x["busy"]:.1f} %' if 'busy' in x else
                f'[dist] {tag} rank {r["rank"]}: host ms a step '
                f'{step:.2f} = forward+backward {fwd:.2f} + all-reduce '
                f'{red:.2f} + update {upd:.2f}; update device ms '
                f'{[round(u, 3) for u in x["update_ms"]]}; '
                f'{BERT_BATCH / step * 1e3:.1f} samples/s over both ranks')
            log(f'[dist] {tag} rank {r["rank"]}: peak memory allocated '
                f'{x["peak"][0]:.2f} GiB, reserved {x["peak"][1]:.2f} GiB; '
                f'losses {x["losses"]}; card {card}')


# ------------------------------------------------------------- dist_async
#: the dist_async phase: the dist phase's BERT-base (16 sequences of 128 a
#: worker, Adam 1e-4) through the parameter server; (a) one worker this
#: many steps, (b) and (c) two workers this many steps on this many
#: servers
DIST_ASYNC_PARITY_STEPS = 3
DIST_ASYNC_STEPS = 4
DIST_ASYNC_SERVERS = 2
#: (b) and (c): BERT-base's widths at this depth, not its 12 layers:
#: their pushes and pulls of its 440 MB took most of the phase's time
DIST_ASYNC_LAYERS = 4
#: (c)'s fault plan, modelled on tests/nightly/dist_async_faults.py's
#: (reset_every:push:3;drop:push:0.3:seed=rank over 6 pushes): a
#: connection reset after the server applied every 25th push, and a lossy
#: link dropping 5 % of the pushes before delivery, seeded by rank, over
#: the 600-odd pushes a worker makes here
DIST_ASYNC_FAULTS = 'reset_every:push:25;drop:push:0.05:seed={rank}'


@contextlib.contextmanager
def _environ(**env):
    """``os.environ`` with ``env`` set inside the block (``None`` unsets
    a name)."""
    import os
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def async_parity(torch, mx, gluon, bert, seed):
    """(a) One worker and its server in this process: DIST_ASYNC_PARITY_STEPS
    steps of BERT-base's widths at DIST_ASYNC_LAYERS layers (cut for
    time, as (b) and (c) are) on 16 sequences through ``Trainer(kvstore=
    'dist_async', update_on_kvstore=True)`` from the same weights as a
    ``kvstore=None`` Trainer's steps, with Adam (B5 on the server), again
    under the fault plan, and with SGD-momentum (B6 on the server). The
    server applies the fused update to the same gradient, copied to the
    host and back, in the same order as the local update graph, so losses
    and weights must be bit-equal; 10 B1, 4 B2 and 60 updates a step in
    each run."""
    from mxnet_tpu_torch.kvstore import dist_async, faults
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import launch
    dev = mx.gpu(0).to_torch()
    mx.random.seed(seed)
    net = bert.bert_12_768_12(max_length=BERT_SEQ, dropout=0.0,
                              use_classifier=False,
                              num_layers=DIST_ASYNC_LAYERS)
    net.initialize(ctx=mx.gpu(0))
    ids, tt, labels = bert_batch(mx, seed, BERT_BATCH // DIST_RANKS,
                                 BERT_SEQ, BERT_VOCAB)
    net(ids, tt)
    params = net.collect_params()
    init = {k: p.data()._data.detach().clone() for k, p in params.items()}
    net.hybridize(static_alloc=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    spec = DIST_ASYNC_FAULTS.format(rank=0)

    def run(opt, hyper, kv, faulted=False):
        for k, p in params.items():
            p.set_data(init[k])
        port = launch.free_ports(1)
        with _environ(MX_COORDINATOR=f'127.0.0.1:{launch.free_ports(1)}',
                      MX_NPROC=1, MX_PROC_ID=0, MXNET_KVSTORE_ASYNC_PORT=port,
                      MXNET_KVSTORE_NUM_SERVERS=None):
            trainer = gluon.Trainer(params, opt, dict(hyper), kvstore=kv,
                                    update_on_kvstore=True if kv else None)
            if faulted:
                faults.configure(spec)
            out = dict(losses=[], counts=[])
            try:
                for _ in range(DIST_ASYNC_PARITY_STEPS):
                    before = kernels.launch_counts()
                    with mx.autograd.record():
                        _, _, mlm = net(ids, tt)
                        loss = loss_fn(mlm, labels).mean()
                    loss.backward()
                    trainer.step(1)
                    _sync(torch, dev)
                    out['losses'].append(loss.item())
                    out['counts'].append(_counts_since(kernels, before))
                if kv:
                    out['transport'] = trainer._kvstore.transport_stats()
                    out['health'] = trainer._kvstore.server_health()[0]
            finally:
                faults.clear()
                if kv:
                    trainer._kvstore.close()
                    dist_async._SERVERS.pop(port).stop()
        out['digests'] = _digests(torch, [p.data()._data
                                          for p in params.values()])
        return out

    for (opt, kernel, hyper), faulted in ((BERT_OPTS[0], True),
                                          (BERT_OPTS[1], False)):
        launches = bert_launches(DIST_ASYNC_LAYERS)
        updated = launches.pop('adam')
        want = dict(launches, **{kernel: updated})
        runs = {'local': run(opt, hyper, None),
                'dist_async': run(opt, hyper, 'dist_async')}
        if faulted:
            runs['under faults'] = run(opt, hyper, 'dist_async', True)
        bad = {t: r['counts'] for t, r in runs.items()
               if any(c != want for c in r['counts'])}
        if bad:
            fail(f'dist_async: (a) {opt} launched {bad}, want {want} a '
                 f'step')
        local, plain = runs['local'], runs['dist_async']
        equal = {t: r['losses'] == local['losses']
                 and r['digests'] == local['digests']
                 for t, r in runs.items() if t != 'local'}
        health = plain['health']
        applied = health['counters']['push_applied']
        faulted_run = runs.get('under faults')
        log(f'[dist_async] (a) one worker, one server in this process, '
            f'{DIST_ASYNC_PARITY_STEPS} {opt} {hyper} steps of '
            f'bert_12_768_12 at {DIST_ASYNC_LAYERS} layers, '
            f'({BERT_BATCH // DIST_RANKS}, {BERT_SEQ}): '
            f'losses {plain["losses"]}, kvstore=None {local["losses"]}; '
            f'losses and weights bit-equal to kvstore=None {equal}'
            + (f' (under {spec}: transport {faulted_run["transport"]}, '
               f'injected {faulted_run["health"]["faults"]})'
               if faulted_run else '')
            + f'; pushes applied {applied}, the server on '
            f'{health["device"]["device"]}, its update span '
            f'{health["device"]["update_ms"]:.2f} device ms over '
            f'{health["device"]["updates"]} pushes; launches a step {want} '
            f'in each run')
        if not all(equal.values()):
            fail(f'dist_async: (a) {opt} through the server trains apart '
                 f'from the local Trainer: {equal}')
        if applied != DIST_ASYNC_PARITY_STEPS * updated or \
                health['device']['device'] != str(dev) or \
                (faulted_run and not faulted_run['transport']['retries']):
            fail(f'dist_async: (a) {opt}: {applied} pushes applied, server '
                 f'on {health["device"]}, retries '
                 f'{faulted_run and faulted_run["transport"]}')
    del net, params, init
    torch.cuda.empty_cache()


def _async_train(torch, mx, gluon, net, params, batch, rank, spec,
                 profile):
    """(b) or (c) in one worker: DIST_ASYNC_STEPS Adam steps through
    ``Trainer(kvstore='dist_async', update_on_kvstore=True)`` on two
    servers. Rank 0 takes its first step, which captures the forward and
    backward graphs, only once its server has begun applying rank 1's
    pushes; with ``profile``, rank 0's last step runs alone (rank 1 waits
    at a barrier) in a checked profiler session. Host ms a step split into
    forward and backward, push, pull and the rest; then every weight
    pulled after a final barrier."""
    from mxnet_tpu_torch.kvstore import faults
    from mxnet_tpu_torch.ops import kernels
    ids, tt, labels = batch
    dev = mx.gpu(0).to_torch()
    trainer = gluon.Trainer(params, 'adam', dict(BERT_OPTS[0][2]),
                            kvstore='dist_async', update_on_kvstore=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    # the optimizer to the servers (rank 0), then rank 0's weights to
    # every rank (init, barrier, pull a key): what the first step does
    # before its pushes
    trainer._prepare_kvstore()
    kv = trainer._kvstore
    spent = dict(push=0.0, pull=0.0)

    def timed(fn, what):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[what] += (time.perf_counter() - t) * 1e3
        return call

    kv.push, kv._pull = timed(kv.push, 'push'), timed(kv._pull, 'pull')
    if spec:
        faults.configure(spec)
    res = dict(losses=[], split=[], counts=[], steps=0)

    def step():
        res['steps'] += 1
        spent.update(push=0.0, pull=0.0)
        t0 = time.perf_counter()
        with mx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).mean()
        loss.backward()
        _sync(torch, dev)
        t1 = time.perf_counter()
        trainer.step(1)
        _sync(torch, dev)
        t2 = time.perf_counter()
        push, pull = spent['push'], spent['pull']
        return loss, ((t1 - t0) * 1e3, push, pull,
                      (t2 - t1) * 1e3 - push - pull)

    def plain():
        before = kernels.launch_counts()
        _sync(torch, dev)
        out = step()
        return out, _counts_since(kernels, before)

    def keep(out, counts):
        res['losses'].append(out[0].item())
        res['split'].append(out[1])
        res['counts'].append(counts)

    def applied():
        return kv.server_health()[0]['counters']['push_applied']

    if rank == 0 and profile:
        deadline = time.monotonic() + 300
        while applied() == 0:
            if time.monotonic() > deadline:
                fail('dist_async: rank 1 pushed nothing in 300 s')
            time.sleep(0.01)
        a = applied()
        keep(*plain())
        res['during_capture'] = applied() - a
    while len(res['losses']) < DIST_ASYNC_STEPS - 1:
        keep(*plain())
    kv.barrier()
    if rank == 0:
        if profile:     # a retry is one more step, counted in 'steps'
            prof, out, _, counts = profile_checked(
                torch, 'dist_async rank 0 step, rank 1 waiting', step)
            keep(out, counts)
            # over its own host ms (the profiler lengthens it a little):
            # the step before ran beside the other worker's
            res['busy'] = _busy_share(prof, sum(res['split'][-1]))
            b5 = [e for e in prof.key_averages()
                  if _kernel_of(e.key) == 'adam']
            res['b5'] = (sum(e.self_device_time_total for e in b5) / 1e3,
                         sum(e.count for e in b5))
        else:
            keep(*plain())
    kv.barrier()
    if rank != 0:
        keep(*plain())
    kv.barrier()        # every push of both workers applied
    faults.clear()
    res['transport'] = kv.transport_stats()
    trained = [(i, p) for i, p in enumerate(trainer._params)
               if p.grad_req != 'null']
    for i, p in trained:
        kv.pull(i, out=p.data()._data)
    _sync(torch, dev)
    res['digests'] = _digests(torch, [p.data()._data for _, p in trained])
    res['nbytes'] = sum(4 * math.prod(p.shape) for _, p in trained)
    res['chunks'] = sum(len(kv._plan(i, tuple(p.shape),
                                     4 * math.prod(p.shape)))
                        for i, p in trained)
    res['keys'] = len(trained)
    res['graphs'] = (net.capture_count, trainer.capture_count,
                     net.eager_call_count)
    if rank == 0:
        res['health'] = kv.server_health()
    kv.barrier()        # no store closes before every rank has pulled
    return res


def _async_rank(seed, base):
    """One worker of (b) and (c) (run by ``parallel.launch.spawn``; the
    workers share cuda:0, rank 0 and rank 1 each holding a server on it):
    each part counted from 0 just before and read just after, on servers
    of its own (ports ``base`` and ``base + 2``)."""
    import os
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    full_fp32(torch)
    rank = dist.get_rank()
    mx.random.seed(seed)
    net = bert.bert_12_768_12(max_length=BERT_SEQ, dropout=0.0,
                              use_classifier=False,
                              num_layers=DIST_ASYNC_LAYERS)
    net.initialize(ctx=mx.gpu(0))
    half = BERT_BATCH // DIST_RANKS
    rows = slice(rank * half, (rank + 1) * half)
    batch = [a[rows] for a in bert_batch(mx, seed, BERT_BATCH, BERT_SEQ,
                                         BERT_VOCAB)]
    net(*batch[:2])                 # deferred initialization
    params = net.collect_params()
    init = {k: p.data()._data.detach().clone() for k, p in params.items()}
    net.hybridize(static_alloc=True)
    dev = mx.gpu(0).to_torch()
    res = {'rank': rank}
    for part, spec in (('b', None),
                       ('c', DIST_ASYNC_FAULTS.format(rank=rank))):
        os.environ['MXNET_KVSTORE_ASYNC_PORT'] = str(
            base + DIST_ASYNC_SERVERS * (part == 'c'))
        for k, p in params.items():
            p.set_data(init[k])
        mem = _memory_start(torch, dev)
        kernels.reset_launch_counts()           # the main path starts
        run = _async_train(torch, mx, gluon, net, params, batch, rank, spec,
                           profile=part == 'b')
        run['launches'] = kernels.launch_counts()   # ... and ends
        run['designs'] = kernels.path_counts()
        run['peak'] = _memory_peaks(torch, dev, mem)
        res[part] = run
    res['profiles'] = list(PROFILES)
    return res


def phase_dist_async(torch, seed):
    """The parameter server: see the module docstring. (a) runs here, (b)
    and (c) in DIST_RANKS workers that share cuda:0. Returns the launch
    counts of (a), (b) and (c) summed, in all and by design, and the
    workers' numbers."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import launch
    kernels.reset_launch_counts()
    async_parity(torch, mx, gluon, bert, seed)
    counts, by_design = kernels.launch_counts(), kernels.path_counts()
    t0 = time.perf_counter()
    base = launch.free_ports(2 * DIST_ASYNC_SERVERS)
    with _environ(MXNET_KVSTORE_NUM_SERVERS=DIST_ASYNC_SERVERS,
                  MXNET_KVSTORE_RPC_DEADLINE_S=300):
        ranks = launch.spawn(_async_rank, DIST_RANKS, seed, base,
                             backend='gloo', timeout=600)
    log(f'[dist_async] {DIST_RANKS} workers on cuda:0 in '
        f'{time.perf_counter() - t0:.1f} s (spawn included)')
    for r in ranks:
        PROFILES.extend(r['profiles'])
        for part in ('b', 'c'):
            for name, c in r[part]['launches'].items():
                counts[name] += c
            for name, ds in r[part]['designs'].items():
                for d, c in ds.items():
                    by_design[name][d] = by_design[name].get(d, 0) + c
    for part, tag in (('b', '(b)'), ('c', '(c) under faults')):
        runs = [r[part] for r in ranks]
        health = runs[0]['health']
        applied = sum(h['counters']['push_applied'] for h in health.values())
        chunks = runs[0]['chunks']
        want = sum(x['steps'] for x in runs) * chunks
        b5 = sum(x['launches']['adam'] for x in runs)
        want_fwd = {k: v for k, v in bert_launches(
            DIST_ASYNC_LAYERS).items() if k != 'adam'}
        fwd = [{k: c.get(k, 0) for k in want_fwd} for x in runs
               for c in x['counts']]
        falls = all(all(math.isfinite(v) for v in x['losses'])
                    and x['losses'][-1] < x['losses'][0] for x in runs)
        equal = all(x['digests'] == runs[0]['digests'] for x in runs)
        retries = sum(x['transport']['retries'] for x in runs)
        devices = sorted({h['device']['device'] for h in health.values()})
        log(f'[dist_async] {tag}: {DIST_RANKS} workers x steps '
            f'{[x["steps"] for x in runs]} x {chunks} pushes a step '
            f'({runs[0]["keys"]} keys, '
            f'{chunks - runs[0]["keys"]} extra chunks of split keys) = '
            f'{want}; the servers applied {applied} '
            f'({[h["counters"]["push_applied"] for h in health.values()]}'
            f' by server, on {devices}), B5 launched {b5} '
            f'({[x["launches"]["adam"] for x in runs]} by process); B1/B2 '
            f'a step {fwd[0]} in every step of every worker: '
            f'{all(f == want_fwd for f in fwd)}; losses '
            f'{[x["losses"] for x in runs]} finite and falling {falls}; '
            f'weights pulled after the last barrier bit-equal {equal}; '
            f'retries {retries}, injected '
            f'{[h["faults"] for h in health.values()][:1]}')
        if applied != want or b5 != want or \
                any(f != want_fwd for f in fwd) or not falls or \
                not equal or devices != ['cuda:0']:
            fail(f'dist_async: {tag} pushes applied {applied}, B5 {b5}, '
                 f'want {want}; forward launches {fwd}; losses falling '
                 f'{falls}; ranks bit-equal {equal}; servers on {devices}')
        if part == 'c' and (retries == 0 or applied != DIST_RANKS
                            * DIST_ASYNC_STEPS * chunks):
            fail(f'dist_async: (c) retries {retries}, pushes applied '
                 f'{applied}, want the fault-free '
                 f'{DIST_RANKS * DIST_ASYNC_STEPS * chunks}')
    first = ranks[0]['b']
    log(f'[dist_async] (b) rank 0 captured its forward and backward graphs '
        f'while its server applied {first["during_capture"]} of rank 1\'s '
        f'pushes; graphs (net, Trainer, eager recorded calls) '
        f'{first["graphs"]}, rank 1 {ranks[1]["b"]["graphs"]}')
    if not first['during_capture'] or \
            any(r[p]['graphs'] != (2, 0, 0) for r in ranks for p in 'bc'):
        fail(f'dist_async: the server applied {first["during_capture"]} '
             f'pushes during rank 0\'s capture; graphs '
             f'{[(r["b"]["graphs"], r["c"]["graphs"]) for r in ranks]}, '
             f'want (2, 0, 0)')
    return counts, by_design, ranks


def dist_async_costs(torch, ranks):
    """Log (d), the dist_async phase's costs, beside the card's name and
    limit: per worker and step host ms split into forward and backward,
    push, pull and the rest (step DIST_ASYNC_STEPS - 1: the one before
    rank 0's profiled step), the servers' update device ms (CUDA events on
    each server's stream) beside B5's kernel time in rank 0's profile, MB
    over the wire, samples/s over both workers, rank 0's busy share and
    the peak memory of each process."""
    card = smi_line()
    health = ranks[0]['b']['health']
    steps = sum(r['b']['steps'] for r in ranks)
    upd = sum(h['device']['update_ms'] for h in health.values())
    b5_ms, b5_n = ranks[0]['b']['b5']
    log(f'[dist_async] (d) the servers\' update device ms (CUDA events on '
        f'the server stream before and after each update: its span there, '
        f'which the host paces as it launches the update\'s small '
        f'hyperparameter copy, bias-correction kernels and B5) '
        f'{[round(h["device"]["update_ms"], 2) for h in health.values()]} '
        f'over {[h["device"]["updates"] for h in health.values()]} pushes, '
        f'{upd / steps:.3f} ms a worker step; B5 kernel time in rank 0\'s '
        f'profiled step {b5_ms:.3f} ms over its {b5_n} launches on server '
        f'0; card {card}')
    # steps 2 .. DIST_ASYNC_STEPS - 1 run while the other worker steps too
    # (the first captures; each worker's last runs while the other waits)
    both = slice(1, DIST_ASYNC_STEPS - 1)
    half = BERT_BATCH // DIST_RANKS
    means = {r['rank']: [sum(col) / len(col) for col in
                         zip(*r['b']['split'][both])] for r in ranks}
    rate = sum(half / sum(m) * 1e3 for m in means.values())
    for r in ranks:
        x = r['b']
        fwd, push, pull, rest = means[r['rank']]
        log(f'[dist_async] (d) worker {r["rank"]}: host ms a step '
            f'{fwd + push + pull + rest:.2f} = forward+backward {fwd:.2f} + '
            f'push {push:.2f} + pull {pull:.2f} + the rest {rest:.2f} (the '
            f'mean of steps 2 to {DIST_ASYNC_STEPS - 1}, both workers '
            f'stepping; all '
            f'{[[round(v, 2) for v in s] for s in x["split"]]}); '
            f'{2 * x["nbytes"] / 1e6:.1f} MB over the wire a step (pushed '
            f'and pulled); '
            + (f'busy {100 * x["busy"]:.1f} % in its last step, alone; '
               if 'busy' in x else '')
            + f'peak {x["peak"][0]:.2f} GiB allocated, {x["peak"][1]:.2f} '
            f'reserved; (c) host ms a step '
            f'{[round(sum(s), 2) for s in r["c"]["split"]]}; card {card}')
    log(f'[dist_async] (d) {rate:.1f} samples/s over both workers ({half} '
        f'sequences a step each, at those steps\' host ms); card {card}')


# ------------------------------------------------------------- ring
#: the ring phase: llama3_8b's attention widths (32 query heads of 128, K/V
#: expanded to 32 heads) over its whole max_length, sharded over sp ranks
#: the sharding phase: (a) llama3_8b at tp = 2, full width at 4 layers,
#: the serve phase's settings; (b) its widths at dp 2 x tp 2 and SHARD_LAYERS
#: layers; (c) BERT-base's widths at 4 of its 12 layers
#: at (32, 128) under mesh(dp=2, tp=2) and mesh(dp=4), SHARD_STEPS Adam
#: steps each; (d) (c)'s dp 2 x tp 2 state through SharedCheckpointManager
SHARD = dict(model='llama3_8b', layers=4, layers_b=4, slots=4,
             max_length=2048, psz=16, chunk=32, n_new=32, dev='cuda',
             bert='bert_12_768_12', bert_kw={'num_layers': 4},
             batch=BERT_BATCH,
             seq=BERT_SEQ, vocab=BERT_VOCAB, steps=BERT_STEPS,
             ckpt=str(ROOT / 'build' / 'sharding_ckpt'))
#: the near tie a parting token must show (the top two logits within this
#: relative gap, and the two runs' logits there within it)
SHARD_TIE = 1e-3


def _serve_all(ds, prompts, n_new):
    """Every prompt through a server stepped by hand (every rank steps its
    own copy of the scheduler in lockstep); tokens, host seconds, stats."""
    futs = [ds.submit(p, n_new) for p in prompts]
    t0 = time.perf_counter()
    while not all(f.done() for f in futs):
        ds.step_once()
    wall = time.perf_counter() - t0
    return [f.result(1) for f in futs], wall, ds.stats()


def _step_ms(torch, ds, dev, reps=5):
    """Host ms of one decode step over every slot (an all-garbage block
    table), the least of ``reps``, and its launch counts."""
    import numpy as np
    from mxnet_tpu_torch.ops import kernels
    n = ds.slots
    bt = np.zeros((n, ds._max_pages), np.int32)
    best = None
    for _ in range(reps):
        _sync(torch, dev)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        ds._run_step([0] * n, [0] * n, bt)
        _sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts_since(kernels, before)
        best = ms if best is None else min(best, ms)
    return best, counts


def _first_part(got, want):
    """``(prompt, position)`` of the first token where two runs part."""
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                return i, j
    return None


def _teacher_logits(torch, net, prompt, toks, j, dev):
    """The logits of the whole vocabulary after ``prompt + toks[:j]``
    (fp32, on the host): the token at ``j`` is picked from them."""
    seq = torch.tensor([list(prompt) + list(toks[:j])], device=dev)
    return net.gather_logits(net(seq))[0, -1].float().cpu()


def _shard_llama_rank(cfg, axes, layers, prompts, want, num_pages=None):
    """(a) or (b) in one rank: the Gluon Llama built and initialized under
    ``mesh(**axes)`` (this rank's shard of each weight, drawn whole in turn
    from the seed by ``LlamaInit``), the
    prompts served with the launch counters set to 0 just before and read
    just after; then one decode step timed alone, and at the first token
    where the run parts from ``want`` (the one-process server's), the
    teacher-forced logits there."""
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.serve import DecodeServer
    from mxnet_tpu_torch.sharding import _collectives as C
    if cfg['dev'] == 'cuda':
        full_fp32(torch)
    dev = torch.device(cfg['dev'], 0) if cfg['dev'] == 'cuda' \
        else torch.device('cpu')
    res = {'rank': dist.get_rank()}
    with mx.sharding.mesh(**axes) as ctx:
        t0 = time.perf_counter()
        kw = {} if layers is None else {'num_layers': layers}
        net = build_llama(cfg['model'], SEED, cfg['dev'], **kw)
        _sync(torch, dev)
        res['build_s'] = time.perf_counter() - t0
        res['weight_bytes'] = param_bytes(net)
        res['allocated'] = torch.cuda.memory_allocated(dev) \
            if dev.type == 'cuda' else None
        res['heads'] = net.model.layers[0].self_attn._heads()
        res['coord'] = {a: ctx.coord(a) for a in ctx.axis_names}
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()           # the main path starts
        C.reset_counters()
        ds = DecodeServer(net, slots=cfg['slots'],
                          max_length=cfg['max_length'],
                          page_size=cfg['psz'], prefill_chunk=cfg['chunk'],
                          num_pages=num_pages, start=False)
        outs, wall, stats = _serve_all(ds, prompts, cfg['n_new'])
        res['launches'] = kernels.launch_counts()   # ... and ends
        res['designs'] = kernels.path_counts()
        res['coll'] = C.counters()
        res.update(outs=outs, wall=wall, steps=stats['steps'],
                   chunks=stats['prefill_chunks'],
                   recompiles=stats['recompiles'],
                   compile_count=stats['compile_count'],
                   pool=tuple(ds._pool[0][0].shape),
                   pool_spec=tuple(ds.pool_spec),
                   rows=ds._rows)
        audit = ds.audit_donation()
        res['audit'] = (audit.ok, dict(audit.stats))
        res['step_ms'], res['step_counts'] = _step_ms(torch, ds, dev)
        res['peak'] = torch.cuda.max_memory_allocated(dev) / 2**30 \
            if dev.type == 'cuda' else None
        ds.close()
        part = _first_part(outs, want) if want is not None else None
        res['part'] = part
        if part is not None:
            i, j = part
            res['part_logits'] = _teacher_logits(torch, net, prompts[i],
                                                 want[i], j, dev)
    del net
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def _bert_data(mx, cfg, seed):
    with (mx.gpu(0) if cfg['dev'] == 'cuda' else mx.cpu()):
        return bert_batch(mx, seed, cfg['batch'], cfg['seq'], cfg['vocab'])


def _bert_net(mx, bert, cfg, seed, ctx):
    mx.random.seed(seed)
    net = bert.get_bert_model(cfg['bert'], max_length=cfg['seq'],
                              dropout=0.0, use_classifier=False,
                              vocab_size=cfg['vocab'], **cfg['bert_kw'])
    net.initialize(ctx=ctx)
    return net


def _shard_bert(torch, mx, gluon, bert, cfg, seed, rules, axes, rank,
                mgr=None):
    """(c) in one rank: BERT from the seeded weights, hybridized, under
    ``mesh(**axes, rules=rules)``, ``cfg['steps']`` Adam steps on the whole
    batch (each rank its rows and shards). Per step: the losses, the
    launch counts, host ms split into forward, backward and update, and
    the collectives' host ms (staging included); the last step's profile
    on rank 0 (every rank runs it again when that profile lost events).
    Returns the gathered weights' digests, the slot bytes and, with
    ``mgr``, the state saved as step ``cfg['steps']`` (d)."""
    import torch.distributed as dist
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.sharding import _collectives as C
    ctxd = mx.gpu(0) if cfg['dev'] == 'cuda' else mx.cpu()
    dev = ctxd.to_torch()
    net = _bert_net(mx, bert, cfg, seed, ctxd)
    ids, tt, labels = _bert_data(mx, cfg, seed)
    net(ids, tt)                    # deferred initialization
    net.hybridize(static_alloc=True)
    params = net.collect_params()
    trainer = gluon.Trainer(params, 'adam', dict(BERT_OPTS[0][2]))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    res = dict(losses=[], split=[], counts=[], coll=[], axes=axes)

    def step():
        C.reset_counters()
        t0 = time.perf_counter()
        with mx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).mean()
        _sync(torch, dev)
        t1 = time.perf_counter()
        loss.backward()
        _sync(torch, dev)
        t2 = time.perf_counter()
        trainer.step(1)
        _sync(torch, dev)
        t3 = time.perf_counter()
        coll = sum(v[2] for v in C.counters().values()) * 1e3
        return loss, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                      coll)

    with mx.sharding.mesh(rules=rules, **axes):
        for i in range(cfg['steps']):
            dist.barrier()
            profile = i == cfg['steps'] - 1 and dev.type == 'cuda'
            before = kernels.launch_counts()
            if not profile:
                out = step()
                counts = _counts_since(kernels, before)
            else:
                rewind = Rewind(torch, trainer)
                for n in range(1, PROFILE_TRIES + 1):
                    before = kernels.launch_counts()
                    if rank == 0:
                        prof, out, _, counts, short = profile_once(
                            torch, f'sharding (c) {axes} rank 0 step', step)
                    else:
                        out, counts, short = step(), None, {}
                        counts = _counts_since(kernels, before)
                    again = [short]
                    dist.broadcast_object_list(again, src=0)
                    if not again[0]:
                        break
                    if n == PROFILE_TRIES:
                        fail(f'sharding: all {n} profiler sessions of rank '
                             f'0\'s step lost kernel events; the last: '
                             f'{again[0]}')
                    rewind()
                    dist.barrier()
            loss, split = out
            res['losses'].append(loss.item())
            res['split'].append(split)
            res['counts'].append(counts)
            if profile and rank == 0:
                res['busy'] = _busy_share(prof, sum(split[:3]))
        res['slot_bytes'] = sum(t.numel() * t.element_size()
                                for st in trainer._states.values()
                                for t in (st if isinstance(st, (list, tuple))
                                          else [st]) if torch.is_tensor(t))
        res['param_bytes'] = sum(p._var.numel() * p._var.element_size()
                                 for p in params.values())
        res['updated'] = len(trainer._sharded_live())
        res['qkv_local'] = tuple(
            net.encoder.cells[0].attention.qkv.weight._var.shape)
        res['graphs'] = (net.capture_count, trainer.capture_count,
                         net.eager_call_count)
        full = {k: p.data().asnumpy() for k, p in params.items()}
        states = trainer.sharded_states()
        sfull = {k: v.asnumpy() for k, v in states.items()}
        res['digests'] = _np_digests(full)
        res['state_digests'] = _np_digests(sfull)
        if rank == 0:
            res['state'] = {k: torch.from_numpy(v) for k, v in full.items()}
        if mgr is not None:
            mgr.save(cfg['steps'], {'params': dict(params),
                                    'trainer': states})
    return res


def _np_digests(arrays):
    import hashlib
    return {k: hashlib.sha256(v.tobytes()).hexdigest()
            for k, v in sorted(arrays.items())}


def _shard_rank4(cfg, prompts, want_b):
    """(b), (c) and (d) in one of four ranks."""
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.sharding.rules import PartitionSpec as P
    if cfg['dev'] == 'cuda':
        full_fp32(torch)
    rank = dist.get_rank()
    res = {'rank': rank}
    # an even page count, so that the pages split on dp: each dp rank's
    # range holds its garbage page and its two slots' whole lengths
    pages = cfg['slots'] * cfg['max_length'] // cfg['psz'] + 2
    res['b'] = _shard_llama_rank(cfg, dict(dp=2, tp=2), cfg['layers_b'],
                                 prompts, want_b, num_pages=pages)
    dev = torch.device(cfg['dev'], 0) if cfg['dev'] == 'cuda' \
        else torch.device('cpu')
    mgr = parallel.SharedCheckpointManager(cfg['ckpt'], max_to_keep=2)
    runs = {}
    for tag, axes, rules in (('dp2tp2', dict(dp=2, tp=2),
                              bert.bert_partition_rules('tp')),
                             ('dp4', dict(dp=4),
                              bert.bert_partition_rules('fsdp'))):
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()           # the main path starts
        run = _shard_bert(torch, mx, gluon, bert, cfg, SEED + 22, rules,
                          axes, rank, mgr if tag == 'dp2tp2' else None)
        run['launches'] = kernels.launch_counts()   # ... and ends
        run['designs'] = kernels.path_counts()
        run['peak'] = torch.cuda.max_memory_allocated(dev) / 2**30 \
            if dev.type == 'cuda' else None
        runs[tag] = run
    res['c'] = runs
    # (d): the dp 2 x tp 2 checkpoint read back under dp 4, every leaf at
    # P('dp') where it divides
    with mx.sharding.mesh(dp=4) as ctx4:
        meta = mgr.step_metadata(mgr.latest_step())
        specs = {}
        for path in meta:
            group, name = path.split('/', 1)
            specs.setdefault(group, {})[name] = P('dp')
        back = mgr.restore(mesh=ctx4, specs=specs)
        res['d'] = {'latest': mgr.latest_step(),
                    'params': _np_digests({k: v.asnumpy() for k, v in
                                           back['params'].items()}),
                    'trainer': _np_digests(_flat_tree(back['trainer']))}
    dist.barrier()
    res['profiles'] = list(PROFILES)
    return res


def _flat_tree(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f'{prefix}{k}/'))
        else:
            out[f'{prefix}{k}'] = v.asnumpy() if hasattr(v, 'asnumpy') \
                else v
    return out


def shard_one_process_serve(torch, cfg, layers, prompts):
    """The one-process server's tokens and tok/s for the same prompts, its
    graphs captured (the serve phase's server)."""
    from mxnet_tpu_torch.serve import DecodeServer
    kw = {} if layers is None else {'num_layers': layers}
    net = build_llama(cfg['model'], SEED, cfg['dev'], **kw)
    ds = DecodeServer(net, slots=cfg['slots'], max_length=cfg['max_length'],
                      page_size=cfg['psz'], prefill_chunk=cfg['chunk'],
                      start=False)
    outs, wall, _ = _serve_all(ds, prompts, cfg['n_new'])
    dev = _device(net)
    step_ms, _ = _step_ms(torch, ds, dev)
    ds.close()
    return net, {'outs': outs, 'wall': wall, 'step_ms': step_ms,
                 'tok_s': sum(map(len, outs)) / wall}


def _near_tie(torch, tag, part, got_logits, want_logits):
    """Where a sharded run parts from one process: the two top logits of
    each within SHARD_TIE relative, and the two runs' logits there within
    SHARD_TIE; else the phase fails."""
    i, j = part
    worst = float((got_logits - want_logits).abs().max()
                  / want_logits.abs().max())
    gaps = []
    for lg in (got_logits, want_logits):
        top = torch.topk(lg, 2).values
        gaps.append(float((top[0] - top[1]) / top[0].abs()))
    ok = worst <= SHARD_TIE and all(g <= SHARD_TIE for g in gaps)
    log(f'[sharding] {tag}: prompt {i} parts from one process at token '
        f'{j}: top-2 relative gaps {gaps}, the runs\' logits apart by '
        f'{worst:.3g} of their largest (both within {SHARD_TIE}) -> '
        f'{"a near tie" if ok else "MISMATCH"}')
    if not ok:
        fail(f'sharding: {tag} prompt {i} parts at token {j} without a '
             f'near tie')


def phase_sharding(torch, seed, cfg=None, serve_ref=None):
    """``mx.sharding`` on the card: see the module docstring. (a) in two
    ranks, (b) to (d) in four, all sharing cuda:0 over gloo, with the
    one-process references run here before each (for (a), the serve
    phase's tokens when it ran: ``serve_ref``). Returns the ranks' summed
    launch counts, in all and by design, and what :func:`sharding_costs`
    logs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.parallel import launch
    cfg = dict(SHARD, **(cfg or {}))
    dev = torch.device(cfg['dev'], 0) if cfg['dev'] == 'cuda' \
        else torch.device('cpu')
    cuda = dev.type == 'cuda'
    counts, by_design = dict.fromkeys(KERNELS, 0), {}

    def add(launches, designs):
        for k, c in launches.items():
            counts[k] = counts.get(k, 0) + c
        for k, ds in designs.items():
            for d, c in ds.items():
                by_design.setdefault(k, {}).setdefault(d, 0)
                by_design[k][d] += c

    # ---- (a) tp = 2, full width at SHARD['layers'] layers
    from mxnet_tpu_torch.gluon.model_zoo.llama import get_llama
    meta = get_llama(cfg['model'], **({} if cfg['layers'] is None
                                      else {'num_layers': cfg['layers']}))
    full_bytes = sum(math.prod(p.shape) * 4
                     for p in meta.collect_params().values())
    L = meta.cfg.num_layers
    prompts = _prompts(torch, meta.cfg.vocab_size, seed)
    if serve_ref is None or cfg['layers'] is not None:
        net, serve_ref = shard_one_process_serve(torch, cfg, cfg['layers'],
                                                 prompts)
        del net
        if cuda:
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ra = launch.spawn(_shard_llama_rank, 2, cfg, dict(tp=2), cfg['layers'],
                      prompts, serve_ref['outs'], backend='gloo',
                      timeout=900)
    log(f'[sharding] (a) 2 ranks on {dev} over gloo in '
        f'{time.perf_counter() - t0:.1f} s (spawn included)')
    for r in ra:
        add(r['launches'], r['designs'])
        calls = r['steps'] + r['chunks'] + 2
        want = _want(fused_norm=(2 * L + 1) * calls,
                     paged_attention_decode=L * (r['steps'] + 1))
        if cuda and {k: r['launches'].get(k, 0) for k in want} != want:
            fail(f'sharding: (a) rank {r["rank"]} launched '
                 f'{r["launches"]}, want {want}')
        step_want = {'fused_norm': 2 * L + 1, 'paged_attention_decode': L}
        if cuda and r['step_counts'] != step_want:
            fail(f'sharding: (a) a decode step launched '
                 f'{r["step_counts"]}, want {step_want}')
        half = r['weight_bytes'] / full_bytes
        if not 0.49 <= half <= 0.51 or r['heads'] != (
                meta.cfg.num_heads // 2, meta.cfg.num_kv_heads // 2) or \
                r['pool'][2] != meta.cfg.num_kv_heads // 2:
            fail(f'sharding: (a) rank {r["rank"]} holds {half:.4f} of the '
                 f'weights, heads {r["heads"]}, pool {r["pool"]}')
        if cuda and not r['weight_bytes'] <= r['allocated'] <= \
                1.02 * r['weight_bytes'] or r['recompiles'] or \
                not r['audit'][0]:
            fail(f'sharding: (a) rank {r["rank"]} allocated '
                 f'{r["allocated"]}, recompiles {r["recompiles"]}, audit '
                 f'{r["audit"]}')
        if r['outs'] != ra[0]['outs']:
            fail('sharding: (a) the two ranks served other tokens')
    part = ra[0]['part']
    gen = sum(map(len, ra[0]['outs']))
    log(f'[sharding] (a) {cfg["model"]} ({L} layers) at tp = 2: each rank '
        f'holds {ra[0]["weight_bytes"] / 2**30:.2f} GiB of weights '
        f'({ra[0]["weight_bytes"] / full_bytes:.4f} of them; '
        f'memory_allocated {(ra[0]["allocated"] or 0) / 2**30:.2f} '
        f'GiB, peak {ra[0]["peak"]} GiB), heads {ra[0]["heads"]} a rank, '
        f'pool {ra[0]["pool"]}; {len(prompts)} requests, {gen} tokens in '
        f'{ra[0]["wall"]:.2f} s ({gen / ra[0]["wall"]:.1f} tok/s), decode '
        f'steps {ra[0]["steps"]}, prefill chunks {ra[0]["chunks"]}, eager '
        f'(compile_count {ra[0]["compile_count"]}, recompiles '
        f'{ra[0]["recompiles"]}), audit {ra[0]["audit"][1]}; a decode step '
        f'{ra[0]["step_ms"]:.2f} host ms a rank and launches '
        f'{ra[0]["step_counts"]}; the graphed one-process server: '
        f'{serve_ref["tok_s"]:.1f} tok/s, a step '
        + (f'{serve_ref["step_ms"]:.2f} ms'
           if serve_ref['step_ms'] is not None
           else '(the serve phase\'s graphed step, [profile] above)')
        + f'; rank 0 collectives {ra[0]["coll"]}; tokens '
        f'{"equal to one process" if part is None else f"part at {part}"}')
    if part is not None:
        net = build_llama(cfg['model'], SEED, cfg['dev'],
                          **({} if cfg['layers'] is None
                             else {'num_layers': cfg['layers']}))
        i, j = part
        want_l = _teacher_logits(torch, net, prompts[i],
                                 serve_ref['outs'][i], j, dev)
        del net
        if cuda:
            torch.cuda.empty_cache()
        _near_tie(torch, '(a)', part, ra[0]['part_logits'], want_l)
    got = {'a': [{k: v for k, v in r.items() if k != 'part_logits'}
                 for r in ra], 'a_ref': serve_ref}
    # ---- (b) to (d): four ranks
    netb, ref_b = shard_one_process_serve(torch, cfg, cfg['layers_b'],
                                          prompts)
    del netb
    bert_ref = shard_one_process_bert(torch, mx, gluon, bert, cfg)
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r4 = launch.spawn(_shard_rank4, 4, cfg, prompts, ref_b['outs'],
                      backend='gloo', timeout=900)
    log(f'[sharding] (b)-(d) 4 ranks on {dev} over gloo in '
        f'{time.perf_counter() - t0:.1f} s (spawn included)')
    for r in r4:
        PROFILES.extend(r['profiles'])
        b = r['b']
        add(b['launches'], b['designs'])
        if b['recompiles'] or not b['audit'][0] or \
                b['pool'][2] != meta.cfg.num_kv_heads // 2 or \
                b['pool_spec'][:3] != ('dp', None, 'tp') or \
                b['pool'][0] != cfg['slots'] * cfg['max_length'] // \
                cfg['psz'] // 2 + 1:
            fail(f'sharding: (b) rank {r["rank"]}: pool {b["pool"]} '
                 f'{b["pool_spec"]}, recompiles {b["recompiles"]}, audit '
                 f'{b["audit"]}')
        if b['part'] is not None:
            fail(f'sharding: (b) rank {r["rank"]} tokens part from the '
                 f'one-process {cfg["layers_b"]}-layer server at '
                 f'{b["part"]}')
    b0 = r4[0]['b']
    gen = sum(map(len, b0['outs']))
    log(f'[sharding] (b) {cfg["model"]} widths, {cfg["layers_b"]} layers, '
        f'dp 2 x tp 2: pool {b0["pool"]} a rank ({b0["pool_spec"]}), slots '
        f'{[r["b"]["rows"] for r in r4]} by rank, tokens equal to the '
        f'one-process server\'s; {gen} tokens in {b0["wall"]:.2f} s '
        f'({gen / b0["wall"]:.1f} tok/s; one process graphed '
        f'{ref_b["tok_s"]:.1f}), a decode step {b0["step_ms"]:.2f} host ms '
        f'(one process {ref_b["step_ms"]:.2f})')
    got['b'] = [r['b'] for r in r4]
    got['b_ref'] = ref_b
    # ---- (c)
    for tag in ('dp2tp2', 'dp4'):
        runs = [r['c'][tag] for r in r4]
        for r in runs:
            add(r['launches'], r['designs'])
        losses = runs[0]['losses']
        ok = all(math.isclose(a, b, rel_tol=1e-4)
                 for a, b in zip(losses, bert_ref['losses']))
        bad, worst = _change_gaps(bert_ref['init'], {
            False: (bert_ref['losses'], bert_ref['state']),
            True: (losses, runs[0]['state'])})
        same = all(r['digests'] == runs[0]['digests'] for r in runs)
        tp = 2 if tag == 'dp2tp2' else 1
        heads = 12 // tp
        bh = cfg['batch'] // (4 // tp) * heads
        per_step = [{k: c.get(k, 0) for k in ('fused_norm',
                                               'flash_attention', 'adam')}
                    for c in runs[0]['counts']]
        want_step = dict(bert_launches(cfg['bert_kw'].get('num_layers',
                                                          12)),
                         adam=runs[0]['updated'])
        b5 = [sum(r['counts'][i].get('adam', 0) for r in runs)
              for i in range(cfg['steps'])]
        plan = sum(r['updated'] for r in runs)
        full_slots = 2 * sum(v.numel() * 4
                             for v in bert_ref['state'].values())
        share = [r['slot_bytes'] / full_slots for r in runs]
        log(f'[sharding] (c) BERT-base {tag}: losses {losses} against one '
            f'process {bert_ref["losses"]} (rtol 1e-4); |sharded change - '
            f'one process\'s change| / |one process\'s change|, worst '
            f'{worst} (1e-2); the ranks\' gathered weights equal {same}; '
            f'per step and rank {per_step} (want {want_step}; flash on BH '
            f'{bh}); B5 summed over the ranks {b5} a step, the ZeRO-1 plan '
            f'{plan}; slot bytes a rank {share} of one process\'s (1/4); '
            f'qkv rows a rank {runs[0]["qkv_local"]}; graphs (net, '
            f'Trainer, eager calls) {runs[0]["graphs"]}')
        if not ok or bad or not same:
            fail(f'sharding: (c) {tag} trains apart from one process: '
                 f'losses {losses} against {bert_ref["losses"]}; past '
                 f'tolerance {bad}; ranks equal {same}')
        if cuda and any(c != want_step for c in per_step):
            fail(f'sharding: (c) {tag} launches a step {per_step}, want '
                 f'{want_step}')
        if cuda and (b5 != [plan] * cfg['steps'] or not all(
                0.24 <= s <= 0.26 for s in share)):
            fail(f'sharding: (c) {tag} B5 {b5} against the plan {plan}, '
                 f'slot shares {share}')
        for r in runs:
            r.pop('state', None)
        got[f'c_{tag}'] = runs
    # ---- (d)
    want_p = r4[0]['c']['dp2tp2']['digests']
    want_s = r4[0]['c']['dp2tp2']['state_digests']
    if any(r['d']['params'] != {f'{k}': v for k, v in want_p.items()} or
           r['d']['trainer'] != want_s for r in r4):
        fail('sharding: (d) the checkpoint read under dp 4 is not the '
             'dp 2 x tp 2 state bit for bit')
    mgr = parallel.SharedCheckpointManager(cfg['ckpt'], max_to_keep=2)
    one = mgr.restore()
    import numpy as np
    one_p = _np_digests({k: np.asarray(v) for k, v in one['params'].items()})
    one_s = _np_digests({f'{k}': np.asarray(v)
                         for k, v in _flat_tree(one['trainer']).items()})
    if one_p != want_p or one_s != want_s:
        fail('sharding: (d) the checkpoint read in one process is not the '
             'dp 2 x tp 2 state bit for bit')
    latest = mgr.latest_step()

    class _Killed(BaseException):
        pass

    def hook(name):
        if name == 'ckpt.renamed':
            raise _Killed(name)
    prev = parallel.checkpoint.install_crash_hook(hook)
    try:
        mgr.save(latest + 1, {'params': one['params']})
        fail('sharding: (d) the crash hook did not fire')
    except _Killed:
        pass
    finally:
        parallel.checkpoint.install_crash_hook(prev)
    after = parallel.SharedCheckpointManager(cfg['ckpt']).latest_step()
    log(f'[sharding] (d) dp 2 x tp 2 weights ({len(want_p)} tensors) and '
        f'Trainer slots ({len(want_s)}) saved by 4 ranks: read back under '
        f'dp 4 and in one process bit-equal (sha256 of each tensor); a '
        f'crash at ckpt.renamed of step {latest + 1} leaves latest_step() '
        f'{after} (want {latest})')
    if after != latest:
        fail(f'sharding: (d) latest_step() {after} after a crash at '
             f'ckpt.renamed, want {latest}')
    got['d'] = {'latest': latest}
    return counts, by_design, got


def shard_one_process_bert(torch, mx, gluon, bert, cfg):
    """(c)'s reference: the same seeded BERT, batch and Adam steps in one
    process (hybridized, graphed on the card)."""
    ctxd = mx.gpu(0) if cfg['dev'] == 'cuda' else mx.cpu()
    net = _bert_net(mx, bert, cfg, SEED + 22, ctxd)
    ids, tt, labels = _bert_data(mx, cfg, SEED + 22)
    net(ids, tt)
    params = net.collect_params()
    init = {k: p.data()._data.detach().cpu().clone()
            for k, p in params.items()}
    net.hybridize(static_alloc=True)
    trainer = gluon.Trainer(params, 'adam', dict(BERT_OPTS[0][2]))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(cfg['steps']):
        with mx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).mean()
        loss.backward()
        trainer.step(1)
        losses.append(loss.item())
    state = {k: p.data()._data.detach().cpu().clone()
             for k, p in params.items()}
    return {'losses': losses, 'init': init, 'state': state}


def sharding_costs(torch, got):
    """(e): per rank, host ms a step split into forward, backward and
    update, and the collectives' share (staging included); peak memory;
    rank 0's busy share; beside the serving numbers of (a) and (b)."""
    for tag in ('dp2tp2', 'dp4'):
        runs = got[f'c_{tag}']
        for r in runs:
            last = r['split'][-1]
            log(f'[sharding] (e) {tag} rank {runs.index(r)}: a step '
                f'{sum(last[:3]):.1f} host ms = forward {last[0]:.1f} + '
                f'backward {last[1]:.1f} + update {last[2]:.1f}, of which '
                f'collectives {last[3]:.1f} (staging included); every '
                f'step {[[round(x, 1) for x in s] for s in r["split"]]}; '
                f'peak {r["peak"]} GiB' + (
                    f'; busy share {r["busy"]:.3f}' if 'busy' in r else ''))
    for key in ('a', 'b'):
        for r in got[key]:
            log(f'[sharding] (e) ({key}) rank {r["rank"]}: build '
                f'{r["build_s"]:.1f} s, a decode step {r["step_ms"]:.2f} '
                f'host ms, peak {r["peak"]} GiB, collectives '
                f'{r["coll"]}')


RING = dict(heads=32, head_dim=128, tokens=8192, ranks=4)
#: the heads the backward is checked on: the ring's backward and dense
#: attention's autograd are plain fp32 PyTorch (about 100 GFLOP a head
#: for the dense reference), so the check takes the first two heads of
#: the same inputs, at the whole 8192 tokens
RING_GRAD_HEADS = 2


def _ring_inputs(torch, seed):
    """q, k, v (1, heads, tokens, head_dim) on cuda:0 from a seeded
    generator: the same tensors in every rank and in the parent (with
    ``seed + 1``, the backward's cotangent first)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    shape = (1, RING['heads'], RING['tokens'], RING['head_dim'])
    return [torch.randn(*shape, generator=gen, device='cuda')
            for _ in range(3)]


def _ring_rank(seed):
    """One rank of the ring phase (run by ``parallel.launch.spawn``; every
    rank shares cuda:0 and the world is gloo). Returns this rank's
    outputs, the launch counts of the main path's two runs, and its
    timings."""
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_stats
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.ring_attention import _Ring, \
        ring_attention
    full_fp32(torch)
    rank, world = dist.get_rank(), dist.get_world_size()
    full = _ring_inputs(torch, seed)
    sl = RING['tokens'] // world
    q, k, v = (x[:, :, rank * sl:(rank + 1) * sl].contiguous() for x in full)
    del full
    torch.cuda.synchronize()
    mesh = make_mesh(sp=world)
    res = {'rank': rank}
    # warm-up: the first call connects gloo's pairs and grows the caches
    ring_attention(q, k, v, mesh, causal=True)
    torch.cuda.synchronize()
    for causal in (True, False):            # the main path, counted
        dist.barrier()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = ring_attention(q, k, v, mesh, causal=causal)
        torch.cuda.synchronize()
        res['host_ms', causal] = (time.perf_counter() - t0) * 1e3
        res['launches', causal] = kernels.launch_counts()
        res['designs', causal] = kernels.path_counts()
        res['out', causal] = out.cpu()
    for causal in (True, False):            # the plain path, not counted
        dist.barrier()
        t0 = time.perf_counter()
        plain = ring_attention(q, k, v, mesh, causal=causal, use_flash=False)
        torch.cuda.synchronize()
        res['plain_host_ms', causal] = (time.perf_counter() - t0) * 1e3
        res['plain_err', causal] = float(
            (plain.cpu() - res['out', causal]).abs().max())
        del plain
    torch.cuda.empty_cache()
    # the backward: the ring under autograd, its gradient of a seeded
    # cotangent; the forward's stats launches counted again
    hg = RING_GRAD_HEADS
    w = _ring_inputs(torch, seed + 1)[0][:, :hg, rank * sl:(rank + 1) * sl]
    for causal in (True, False):
        leaves = [x[:, :hg].detach().clone().requires_grad_()
                  for x in (q, k, v)]
        dist.barrier()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ring_attention(*leaves, mesh, causal=causal).backward(w)
        torch.cuda.synchronize()
        res['grad_ms', causal] = (time.perf_counter() - t0) * 1e3
        res['grad_launches', causal] = kernels.launch_counts()
        res['grads', causal] = [x.grad.cpu() for x in leaves]
        del leaves
        torch.cuda.empty_cache()
    # the rotation alone, every rank at once: the staging (two pinned
    # host buffers and the copy of this rank's K/V into one), then world -
    # 1 steps of the K/V block through gloo and back onto the card
    dist.barrier()
    t0 = time.perf_counter()
    ring = _Ring([k, v], mesh.get_group('sp'))
    t1 = time.perf_counter()
    for _ in range(world - 1):
        ring.start()
        ring.finish()
    torch.cuda.synchronize()
    res['staging_ms'] = (t1 - t0) * 1e3
    res['transport_ms'] = (time.perf_counter() - t1) * 1e3
    del ring
    # this rank's blocks through the stats kernel, each rank alone on the
    # card in turn: causal, r full blocks and one diagonal; full, world
    b, h, _, d = q.shape
    qs, ks, vs = (x.view(b * h, sl, d) for x in (q, k, v))
    for r in range(world):
        dist.barrier()
        if r == rank:
            res['b3_ms', False] = cuda_ms(torch, lambda: flash_attention_stats(
                qs, ks, vs, d ** -0.5, False))
            res['b3_ms', True] = cuda_ms(torch, lambda: flash_attention_stats(
                qs, ks, vs, d ** -0.5, True))
    dist.barrier()
    return res


def phase_ring(torch, seed):
    """Ring attention over ``RING['ranks']`` processes that share cuda:0,
    over gloo (NCCL refuses two ranks on one card), each K/V block through
    pinned host buffers. Holds every rank to exactly r + 1 stats launches
    causal and ``ranks`` full; the gathered output to plain dense
    attention and to the flash forward (B2) over the whole sequence; the
    flash path to the plain blockwise path. Returns the summed launch
    counts of the main path's runs, in all and by design."""
    from mxnet_tpu_torch.ops.kernels import flash_attention
    from mxnet_tpu_torch.parallel import launch
    n = RING['ranks']
    t0 = time.perf_counter()
    ranks = launch.spawn(_ring_rank, n, seed, backend='gloo', timeout=600)
    log(f'[ring] {n} ranks on cuda:0 over gloo, (1, {RING["heads"]}, '
        f'{RING["tokens"]}, {RING["head_dim"]}) fp32 sharded '
        f'{RING["tokens"] // n} a rank, in '
        f'{time.perf_counter() - t0:.1f} s (spawn included)')
    counts = dict.fromkeys(KERNELS, 0)
    by_design = {}
    for r in ranks:
        for causal in (True, False):
            for name, ds in r['designs', causal].items():
                for d, c in ds.items():
                    by_design.setdefault(name, {}).setdefault(d, 0)
                    by_design[name][d] += c
            got = r['launches', causal]['flash_attention_stats']
            grad = r['grad_launches', causal]
            want = r['rank'] + 1 if causal else n
            if got != want or grad != dict(r['launches', causal]):
                fail(f'ring: rank {r["rank"]} launched the stats kernel '
                     f'{got} times {"causal" if causal else "full"}, want '
                     f'{want}; under autograd {grad}')
            for name, c in r['launches', causal].items():
                counts[name] += c
        log(f'[ring] rank {r["rank"]}: host ms causal '
            f'{r["host_ms", True]:.2f} full {r["host_ms", False]:.2f} '
            f'(plain path {r["plain_host_ms", True]:.2f} / '
            f'{r["plain_host_ms", False]:.2f}); B3 kernel ms causal '
            f'{r["rank"] * r["b3_ms", False] + r["b3_ms", True]:.4f} '
            f'({r["rank"]} full x {r["b3_ms", False]:.4f} + 1 diagonal x '
            f'{r["b3_ms", True]:.4f}), full {n * r["b3_ms", False]:.4f}; '
            f'transport ms {r["transport_ms"]:.2f} for {n - 1} rotations '
            f'(after {r["staging_ms"]:.2f} ms of staging set-up); '
            f'flash vs plain max err {r["plain_err", True]:.3e} / '
            f'{r["plain_err", False]:.3e}; forward and backward under '
            f'autograd host ms causal {r["grad_ms", True]:.2f} full '
            f'{r["grad_ms", False]:.2f} (the same stats launches, a plain '
            f'backward)')
    tol = (1e-4, 1e-4)
    q, k, v = (x.view(RING['heads'], RING['tokens'], RING['head_dim'])
               for x in _ring_inputs(torch, seed))
    scale = RING['head_dim'] ** -0.5
    for causal in (True, False):
        got = torch.cat([r['out', causal] for r in ranks], dim=2).cuda()
        got = got.view_as(q)
        for what, fn in (
                ('plain dense attention',
                 flash_attention.flash_attention_plain),
                ('the flash forward (B2)', flash_attention.flash_attention_fwd)):
            want = fn(q, k, v, scale, causal)
            err, ok = compare(torch, got, want, *tol)
            log(f'[ring] {"causal" if causal else "full"}: gathered output '
                f'vs {what} over {RING["tokens"]} tokens: max_abs_err '
                f'{err:.3e} (rtol {tol[0]:g}, atol {tol[1]:g}: fp32 online '
                f'softmax merged across ranks vs one pass) -> '
                f'{"ok" if ok else "MISMATCH"}')
            if not ok:
                fail(f'ring: the gathered output disagrees with {what}')
            del want
            torch.cuda.empty_cache()
        perr = max(r['plain_err', causal] for r in ranks)
        if not perr <= 1e-4:
            fail(f'ring: the flash path and the plain path part by {perr}')
        del got
        ring_grad_checks(torch, flash_attention, ranks, q, k, v, scale,
                         causal, seed)
    del q, k, v
    torch.cuda.empty_cache()
    return counts, by_design


def ring_grad_checks(torch, flash_attention, ranks, q, k, v, scale, causal,
                     seed):
    """The ranks' q, k and v gradients of the first ``RING_GRAD_HEADS``
    heads, gathered, against autograd through plain dense attention over
    the whole sequence, at rtol 1e-4 and an atol of 1e-4 of each gradient's largest
    entry: the ring sums each gradient over 4 blocks of 2048 keys from
    the 3xTF32 kernel's statistics, dense attention over 8192 keys in one
    pass; fp32 sums of 8192 terms in two orders part by about 1e-6 of
    their largest term, and the tolerance leaves two orders of margin."""
    hg = RING_GRAD_HEADS
    cot = _ring_inputs(torch, seed + 1)[0].view_as(q)[:hg]
    leaves = [x[:hg].detach().clone().requires_grad_() for x in (q, k, v)]
    flash_attention.flash_attention_plain(*leaves, scale,
                                          causal).backward(cot)
    errs, ok = [], True
    for i, name in enumerate('qkv'):
        got = torch.cat([r['grads', causal][i] for r in ranks],
                        dim=2).cuda().view_as(leaves[i])
        want = leaves[i].grad
        err, good = compare(torch, got, want, 1e-4,
                            1e-4 * float(want.abs().max()))
        errs.append((f'd{name}', float(f'{err:.3g}'),
                     float(f'{float(want.abs().max()):.3g}')))
        ok = ok and good
        del got
    del leaves, cot
    torch.cuda.empty_cache()
    log(f'[ring] {"causal" if causal else "full"}: gathered gradients of '
        f'heads 0-{hg - 1} vs autograd through plain dense attention over '
        f'{RING["tokens"]} tokens, (max_abs_err, max |want|): {errs} (rtol '
        f'1e-4, atol 1e-4 of the largest) -> {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('ring: the backward ring\'s gradients disagree with dense '
             'attention\'s')


# ------------------------------------------------------------- rtc
RTC_SOURCE = r'''
extern "C" __global__ void double_kernel(const float* x, long long n,
                                         float* y) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

// out = a * x + y rounded as torch rounds it (no contraction into an
// FMA), and the sign of x as an int
extern "C" __global__ void axpy_sign(const float* x, const float* y,
                                     float a, long long n, float* out,
                                     int* sign) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = __fadd_rn(__fmul_rn(a, x[i]), y[i]);
    sign[i] = x[i] < 0.f ? -1 : 1;
  }
}
'''
RTC_SHAPE = (4096, 14336)


def phase_rtc(torch, seed):
    """The user-facing rtc path: ``CudaModule`` compiles ``RTC_SOURCE``
    with NVRTC and launches both kernels once at ``RTC_SHAPE``. Returns
    what ``rtc_checks`` holds against the torch twins."""
    from mxnet_tpu_torch.rtc import CudaModule
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x, y = (torch.randn(*RTC_SHAPE, generator=gen, device='cuda')
            for _ in range(2))
    t0 = time.perf_counter()
    mod = CudaModule(RTC_SOURCE, exports=('double_kernel', 'axpy_sign'))
    dbl, axpy = mod.get_kernel('double_kernel'), mod.get_kernel('axpy_sign')
    n = x.numel()
    grid = ((n + 255) // 256,)
    (d2,) = dbl.launch([x, n], grid, 256, x.shape)
    torch.cuda.synchronize()
    log(f'[rtc] compiled (NVRTC, sm_90a) and launched in '
        f'{time.perf_counter() - t0:.2f} s: {dbl}, {axpy}')
    out, sign = axpy.launch([x, y, 0.37, n], grid, 256, [x.shape, x.shape],
                            ['float32', 'int32'])
    torch.cuda.synchronize()
    return dict(x=x, y=y, n=n, grid=grid, kernels=(dbl, axpy),
                got=(d2, out, sign))


def rtc_checks(torch, rows, x, y, n, grid, kernels, got):
    """Both rtc kernels bit-equal to their torch twins, timed against the
    bytes they must move (their rows in the kernels line)."""
    dbl, axpy = kernels
    why = 'the same fp32 roundings, none contracted'
    rows['rtc'].append(_case(
        torch, 'rtc', f'double_kernel {RTC_SHAPE} fp32', got[0], x * 2,
        (0.0, 0.0), why,
        lambda: dbl.launch([x, n], grid, 256, x.shape),
        lambda: x * 2.0, 8 * n, n, lambda: torch.mul(x, 2.0)))
    rows['rtc'].append(_case(
        torch, 'rtc', f'axpy_sign {RTC_SHAPE} fp32 -> fp32, int32',
        (got[1], got[2]), (0.37 * x + y, torch.where(x < 0, -1, 1).int()),
        (0.0, 0.0), why,
        lambda: axpy.launch([x, y, 0.37, n], grid, 256, [x.shape, x.shape],
                            ['float32', 'int32']),
        lambda: (0.37 * x + y, torch.where(x < 0, -1, 1).int()),
        16 * n, 3 * n, None))
    if not all(r['ok'] for r in rows['rtc']):
        fail('rtc: a kernel compiled from CUDA source disagrees with its '
             'torch twin')


#: the designs the main paths must run, the Hopper ones; the int8
#: product's earlier design (``sm80``) stays for layouts that TMA
#: refuses, and the norm's (``general``) for widths and layouts that the
#: register-resident designs do not take; no main path gives them those.
#: Paged decode has one design, counted by the split count of its plan (1
#: to 8)
# ------------------------------------------------------------ elastic
#: elastic (a): bert_12_768_12 in one process, fp32, (32, 128) batches of
#: a shuffled resumable loader over this many seeded samples, Adam, Dropout
#: 0.1, hybridized; steps are numbered from 1, a run of ELASTIC_STEPS
#: straight against one killed inside its save of step ELASTIC_KILL_AT
ELASTIC_STEPS, ELASTIC_KILL_AT = 6, 3
#: at BERT-base's widths cut to ``layers`` of its 12 (its three processes
#: at 12 layers took most of the phase's 251 s in the run before)
ELASTIC_A = dict(samples=256, batch=BERT_BATCH, seq=BERT_SEQ,
                 vocab=BERT_VOCAB, layers=4, bert_kw={}, dev='cuda')
#: elastic (b): four ranks as two hosts of two, bert_12_768_12's widths
#: at this depth under FSDP (bert_partition_rules('fsdp')), Adam; host 1
#: dies after step ``commit`` is committed (at the barrier of the next
#: step, or inside its second collective); ``deadline_s`` is
#: MXNET_KVSTORE_DEADLINE_S, which bounds the detection
ELASTIC_B = dict(layers=4, steps=5, commit=2, deadline_s=6, bert_kw={},
                 dev='cuda')
ELASTIC_DIR = ROOT / 'build' / 'elastic'
#: CHIP_SMOKE_REHEARSE=1 runs the elastic, pipeline and moe phases' code
#: on the CPU at tiny widths (a check of the script, not of the card)
REHEARSE = os.environ.get('CHIP_SMOKE_REHEARSE') == '1'
_TINY_BERT = dict(units=32, hidden_size=64, num_heads=4, num_layers=2)
if REHEARSE:
    ELASTIC_A.update(samples=48, batch=8, seq=16, vocab=100,
                     layers=_TINY_BERT['num_layers'], bert_kw=_TINY_BERT,
                     dev='cpu')
    ELASTIC_B.update(deadline_s=3, bert_kw=_TINY_BERT, dev='cpu')


def deterministic(torch):
    """Bit-exact runs on the card: deterministic algorithms (the backward
    of an embedding lookup adds its rows with atomics otherwise, in an
    order that changes from run to run) and cuBLAS's fixed workspace,
    which must be set before cuBLAS starts."""
    os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
    torch.use_deterministic_algorithms(True)


def _ctxd(mx, dev):
    return mx.gpu(0) if dev == 'cuda' else mx.cpu()


def _sync_all(torch, dev):
    if dev == 'cuda':
        torch.cuda.synchronize()


def _elastic_a_build(torch, mx, gluon, bert, parallel, ElasticTrainer, ckpt,
                     seed):
    import numpy as np
    a = ELASTIC_A
    mx.random.seed(seed)
    net = bert.get_bert_model('bert_12_768_12', max_length=a['seq'],
                              dropout=0.1, use_classifier=False,
                              vocab_size=a['vocab'], **dict(
                                  a['bert_kw'], num_layers=a['layers']))
    net.initialize(ctx=_ctxd(mx, a['dev']))
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, a['vocab'], (a['samples'], a['seq']))
    labels = rng.integers(0, a['vocab'], (a['samples'], a['seq']))
    zeros = mx.np.zeros((a['batch'], a['seq']), dtype='int32')
    with mx.autograd.predict_mode():
        net(zeros, zeros)           # deferred initialization
    net.hybridize(static_alloc=True)
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(ids.astype('int32'), labels.astype('int32')),
        batch_size=a['batch'], shuffle=True)
    it = loader.resumable(shuffle_seed=5)
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            dict(BERT_OPTS[0][2]))
    et = ElasticTrainer(dict(net.collect_params()), trainer,
                        parallel.SharedCheckpointManager(ckpt, max_to_keep=2),
                        data_iter=it, name='bert')
    return net, trainer, it, et, zeros


def elastic_worker(mode, ckpt, out):
    """One process of elastic (a): ``straight`` trains ELASTIC_STEPS steps;
    ``crash`` trains with the asynchronous daemon, saving after every step,
    and is SIGKILLed inside the daemon's save of step ELASTIC_KILL_AT (at
    ``ckpt.staged``: staged, not committed); ``resume`` compiles its graphs
    on a zero batch (a recorded call and a Trainer step twice: eager, then
    captured), restores the newest checkpoint over them and trains the rest.
    Dumps weights, Adam slots, the update count, the losses and the launch
    counts to ``out``."""
    import os
    import signal
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import checkpoint
    from mxnet_tpu_torch.train import ElasticTrainer
    if ELASTIC_A['dev'] == 'cuda':
        full_fp32(torch)
        deterministic(torch)
    kernels.reset_launch_counts()
    ctx = _ctxd(mx, ELASTIC_A['dev'])
    ctx.__enter__()         # this process's arrays and batches go there
    net, trainer, it, et, zeros = _elastic_a_build(
        torch, mx, gluon, bert, parallel, ElasticTrainer, ckpt, SEED + 30)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    res = {'losses': {}, 'counts': {}}

    def step(n):
        ids, labels = next(it)
        before = kernels.launch_counts()
        loss = bert_step(mx, net, trainer, loss_fn, ids,
                         mx.np.zeros(ids.shape, dtype='int32'), labels)
        res['losses'][n] = loss.item()
        res['counts'][n] = _counts_since(kernels, before)

    if mode == 'crash':
        def hook(point):
            if point == 'ckpt.staged' and os.path.isdir(
                    os.path.join(ckpt, f'.staging-{ELASTIC_KILL_AT}')):
                os.kill(os.getpid(), signal.SIGKILL)
        checkpoint.install_crash_hook(hook)
        for n in range(1, ELASTIC_KILL_AT + 1):
            step(n)
            # durable before the next step: nothing is coalesced away
            et.save(n, block=True)
            log('ELASTIC_STATS ' + json.dumps(et.stats()))
        fail('elastic: the save of the last step did not kill')
    start = 0
    if mode == 'resume':
        for _ in range(2):
            bert_step(mx, net, trainer, loss_fn, zeros, zeros, zeros)
        start = et.restore()
    for n in range(start + 1, ELASTIC_STEPS + 1):
        step(n)
    _sync_all(torch, ELASTIC_A['dev'])
    res['start'] = start
    res['weights'] = {k: p.data()._data.cpu().clone()
                      for k, p in net.collect_params().items()}
    res['slots'] = {i: [t.cpu().clone() for t in (st if isinstance(st, tuple)
                                          else (st,)) if torch.is_tensor(t)]
                    for i, st in trainer._states.items()}
    res['num_update'] = trainer._optimizer.num_update
    res['launches'] = kernels.launch_counts()
    res['designs'] = kernels.path_counts()
    res['graphs'] = (net.capture_count, trainer.capture_count)
    torch.save(res, out)
    et.close()
    return 0


def _elastic_a(torch):
    """Elastic (a) through three processes of this script; returns the
    straight and resumed dumps and the crashed run's last stats."""
    import os
    import shutil
    from mxnet_tpu_torch import parallel
    base = ELASTIC_DIR / 'a'
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    ckpt = str(base / 'ckpt')
    got = {}
    for mode in ('straight', 'crash', 'resume'):
        env = dict(os.environ)
        if mode == 'crash':
            env['MXNET_CKPT_ASYNC'] = '1'
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(ROOT / 'chip_smoke.py'), '--elastic-worker',
             mode, '--ckpt', ckpt, '--out', str(base / f'{mode}.pt')],
            capture_output=True, text=True, timeout=600, env=env)
        dt = time.perf_counter() - t0
        want_rc = -9 if mode == 'crash' else 0
        if r.returncode != want_rc:
            fail(f'elastic: (a) {mode} exited {r.returncode} (want '
                 f'{want_rc}):\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}')
        stats = [json.loads(line.split(' ', 1)[1])
                 for line in r.stdout.splitlines()
                 if line.startswith('ELASTIC_STATS ')]
        got[mode] = (torch.load(base / f'{mode}.pt', weights_only=False)
                     if mode != 'crash' else stats[-1] if stats else None)
        log(f'[elastic] (a) {mode} process: {dt:.1f} s')
        if mode == 'crash':
            latest = parallel.SharedCheckpointManager(ckpt).latest_step()
            if latest != ELASTIC_KILL_AT - 1:
                fail(f'elastic: (a) after the kill latest_step() is '
                     f'{latest}, want {ELASTIC_KILL_AT - 1}')
    return got


def _elastic_a_checks(torch, got):
    a, b, st = got['straight'], got['resume'], got['crash']
    if b['start'] != ELASTIC_KILL_AT - 1:
        fail(f'elastic: (a) resumed from {b["start"]}')
    bad = [k for k in a['weights']
           if not torch.equal(a['weights'][k], b['weights'][k])]
    bad += [f'slot {i}' for i in a['slots']
            if len(a['slots'][i]) != len(b['slots'][i]) or not all(
                torch.equal(x, y)
                for x, y in zip(a['slots'][i], b['slots'][i]))]
    losses = [n for n in range(ELASTIC_KILL_AT, ELASTIC_STEPS + 1)
              if a['losses'][n] != b['losses'][n]]
    if bad or losses or a['num_update'] != b['num_update'] or \
            a['slots'].keys() != b['slots'].keys():
        fail(f'elastic: (a) the resumed run is not bit-equal to the '
             f'straight one: tensors {bad[:5]} ({len(bad)}), losses at '
             f'steps {losses}, num_update {a["num_update"]} / '
             f'{b["num_update"]}')
    per_step = a['counts'][ELASTIC_STEPS]
    want = bert_launches(ELASTIC_A['layers'])
    if not REHEARSE and {k: per_step.get(k, 0) for k in want} != want:
        fail(f'elastic: (a) a step launched {per_step}, want {want}')
    log(f'[elastic] (a) bert_12_768_12 at {ELASTIC_A["layers"]} layers '
        f'({ELASTIC_A["batch"]}, {ELASTIC_A["seq"]}) Adam Dropout 0.1, '
        f'hybridized (captures net/trainer {a["graphs"]}): {ELASTIC_STEPS} '
        f'steps straight against a run SIGKILLed inside its save of step '
        f'{ELASTIC_KILL_AT} and resumed from step {b["start"]}: weights, '
        f'{sum(len(v) for v in a["slots"].values())} Adam slots, '
        f'num_update {a["num_update"]} and the losses of steps '
        f'{ELASTIC_KILL_AT}-{ELASTIC_STEPS} bit-equal; losses '
        f'{[round(a["losses"][n], 6) for n in sorted(a["losses"])]}; a '
        f'step launches B1 {per_step.get("fused_norm")} B2 '
        f'{per_step.get("flash_attention")} B5 {per_step.get("adam")}; the '
        f'crashed run\'s async saves: blocked_ms avg '
        f'{st["blocked_ms_avg"]:.2f} max {st["blocked_ms_max"]:.2f}, '
        f'serialize_ms avg {st["serialize_ms_avg"]:.1f} max '
        f'{st["serialize_ms_max"]:.1f} ({st["async_saves"]} saves)')


def _elastic_b_rank(mode, ckpt, seed):
    """One rank of elastic (b). ``mode``: ``barrier`` (host 1's ranks die
    at their elastic barrier before step commit + 1), ``collective``
    (inside that step's second collective) or ``planned`` (two ranks
    restore the ``barrier`` run's checkpoint of step ``commit`` and train
    to the end, the planned scale-down). Returns digests of the final
    weights, per-step host ms and launches, and the re-formation's
    timings."""
    import os
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, kvstore, parallel
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.kvstore import faults
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import launch
    from mxnet_tpu_torch.sharding.context import MeshGroup, local_group, use
    from mxnet_tpu_torch.train import ElasticTrainer, MeshElasticTrainer
    os.environ.update(MXNET_KVSTORE_DEADLINE_S=str(ELASTIC_B['deadline_s']),
                      MXNET_KVSTORE_HEARTBEAT_S='0.5')
    dev = ELASTIC_B['dev']
    if dev == 'cuda':
        full_fp32(torch)
        deterministic(torch)
    else:
        torch.set_num_threads(1)
    kernels.reset_launch_counts()
    rank = dist.get_rank()
    cfg = dict(SHARD, dev=dev, bert_kw=dict(
        ELASTIC_B['bert_kw'], num_layers=ELASTIC_B['layers']))
    if dev != 'cuda':
        cfg.update(batch=8, seq=16, vocab=100)
    kill = ELASTIC_B['commit'] + 1
    rules = bert.bert_partition_rules('fsdp')
    steps = []
    opts = dict(BERT_OPTS[0][2])
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def build(ctx):
        ctxd = _ctxd(mx, dev)
        net = _bert_net(mx, bert, cfg, seed, ctxd)
        ids, tt, labels = _bert_data(mx, cfg, seed)
        with mx.autograd.predict_mode():
            net(ids, tt)            # deferred initialization, whole
        params = net.collect_params()
        init = {k: p.data().asnumpy() for k, p in params.items()}
        net.hybridize(static_alloc=True)
        trainer = gluon.Trainer(params, 'adam', dict(opts))
        bert_step(mx, net, trainer, loss_fn, ids, tt, labels)  # places
        for k, p in params.items():
            p.set_data(init[k])
        trainer = gluon.Trainer(params, 'adam', dict(opts))

        def step(s):
            if mode == 'collective' and s == kill and rank >= 2:
                faults.configure(f'kill_host:collective:2:rank={rank}')
            ids, tt, labels = _bert_data(mx, cfg, seed + 100 + s)
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            loss = bert_step(mx, net, trainer, loss_fn, ids, tt, labels)
            loss = loss.item()
            steps.append(dict(step=s, ranks=ctx.n_devices, loss=loss,
                              ms=(time.perf_counter() - t0) * 1e3,
                              counts=_counts_since(kernels, before)))
        return {'params': dict(params), 'trainer': trainer, 'step': step}

    out = {'rank': rank, 'steps': steps}
    if mode == 'planned':
        g = MeshGroup(2, devices=[0, 1, 2, 3], live=[0])
        ctx = g.context(rules=rules, group=local_group([0, 1]))
        with _ctxd(mx, dev), use(ctx):
            st = build(ctx)
            et = ElasticTrainer(st['params'], st['trainer'],
                                parallel.SharedCheckpointManager(ckpt),
                                name='planned', async_save=False)
            out['restored'] = et.restore(ELASTIC_B['commit'])
            for s in range(ELASTIC_B['commit'] + 1, ELASTIC_B['steps']):
                st['step'](s)
            weights = {k: p.data().asnumpy() for k, p in st['params'].items()}
            et.close()
    else:
        with _ctxd(mx, dev):
            store = kvstore.create('dist_async', device='cpu')
            if mode == 'barrier':
                n = 2 * kill + 1   # its elastic_barrier sends to pre(kill)
                faults.configure(';'.join(
                    f'kill_host:elastic_barrier:{n}:rank={r}'
                    for r in (2, 3)))
            d = MeshElasticTrainer(store, MeshGroup(2, devices=[0, 1, 2, 3]),
                                   build, ckpt, rules=rules, name='bert')
            dist.barrier()
            t0 = time.perf_counter()
            try:
                out['done'] = d.run(ELASTIC_B['steps'])
            except faults.InjectedHostDeath:
                launch.die()
            out['wall'] = time.perf_counter() - t0
            out['timings'] = d.timings
            out['committed'] = d.committed
            out['group'] = d.group.describe()
            out['table'] = store.mesh_table()
            weights = {k: p.data().asnumpy()
                       for k, p in d.state['params'].items()}
            d.close()
    out['digests'] = _np_digests(weights)
    out['launches'] = kernels.launch_counts()
    out['designs'] = kernels.path_counts()
    return out


def _elastic_b(torch, seed):
    """Elastic (b): the two deaths and the planned scale-down; returns the
    ranks' results by run."""
    import shutil
    from mxnet_tpu_torch.parallel import launch
    base = ELASTIC_DIR / 'b'
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    got = {}
    for mode, n, ckpt in (('barrier', 4, 'barrier'),
                          ('collective', 4, 'collective'),
                          ('planned', 2, 'barrier')):
        t0 = time.perf_counter()
        got[mode] = launch.spawn(_elastic_b_rank, n, mode,
                                 str(base / ckpt), seed, backend='gloo',
                                 timeout=900, may_die=mode != 'planned')
        log(f'[elastic] (b) {mode}: {n} ranks on cuda:0 over gloo in '
            f'{time.perf_counter() - t0:.1f} s (spawn included)')
    return got


def _elastic_b_checks(got):
    commit, steps = ELASTIC_B['commit'], ELASTIC_B['steps']
    layers = ELASTIC_B['layers']
    want_b = bert_launches(layers)
    want = got['planned'][0]['digests']
    if got['planned'][0]['restored'] != commit:
        fail(f'elastic: (b) the planned run restored '
             f'{got["planned"][0]["restored"]}, want {commit}')
    for mode in ('barrier', 'collective'):
        ranks = got[mode]
        if ranks[2:] != [None, None] or None in ranks[:2]:
            fail(f'elastic: (b) {mode}: host 1 did not die alone')
        for r in ranks[:2]:
            if r['done'] != steps or r['group']['live'] != [0]:
                fail(f'elastic: (b) {mode} rank {r["rank"]}: done '
                     f'{r["done"]}, live hosts {r["group"]["live"]}')
            if r['digests'] != want:
                bad = [k for k in want if r['digests'].get(k) != want[k]]
                fail(f'elastic: (b) {mode} rank {r["rank"]}: weights not '
                     f'bit-equal to the planned scale-down: {bad[:5]} '
                     f'({len(bad)})')
            t = r['timings'][0]
            if sum(t.values()) > 120:
                fail(f'elastic: (b) {mode}: the re-formation took {t}')
            per = {s['ranks']: {k: s['counts'].get(k, 0) for k in want_b}
                   for s in r['steps']}
            if not REHEARSE and per != {4: want_b, 2: want_b}:
                fail(f'elastic: (b) {mode}: a step launched {per} by mesh '
                     f'size, want {want_b} at 4 and at 2 ranks')
    for mode in ('barrier', 'collective'):
        r = got[mode][0]
        t = r['timings'][0]
        before = [s['ms'] for s in r['steps'] if s['ranks'] == 4]
        after = [s['ms'] for s in r['steps'] if s['ranks'] == 2]
        first = after[0]
        where = 'at the barrier of' if mode == 'barrier' else \
            'inside the second collective of'
        log(f'[elastic] (b) host 1 dies {where} '
            f'step {commit + 1} ({ELASTIC_B["layers"]}-layer '
            f'bert_12_768_12 widths, FSDP, Adam): death to the first step '
            f'on the new mesh {sum(t.values()) + first / 1e3:.2f} s = '
            f'detect {t["detect"]:.2f} + drain {t["drain"]:.3f} + restore '
            f'{t["restore"]:.2f} + rejoin {t["rejoin"]:.3f} + first step '
            f'{first / 1e3:.2f} (MXNET_KVSTORE_DEADLINE_S '
            f'{ELASTIC_B["deadline_s"]}); step host ms at 4 ranks '
            f'{[round(x, 1) for x in before]}, at 2 '
            f'{[round(x, 1) for x in after]}; a step launches '
            f'{r["steps"][-1]["counts"]} a rank; mesh table {r["table"]}; '
            f'weights bit-equal to the planned scale-down (4 ranks to step {commit}, its checkpoint '
            f'restored on 2)')


def phase_elastic(torch, seed):
    """``mx.train``'s elastic trainers on the card: see the module
    docstring. Returns the processes' summed launch counts, by kernel and
    by design."""
    got_a = _elastic_a(torch)
    _elastic_a_checks(torch, got_a)
    got_b = _elastic_b(torch, seed)
    _elastic_b_checks(got_b)
    counts, designs = dict.fromkeys(KERNELS, 0), {}
    runs = [got_a['straight'], got_a['resume']] + [
        r for rs in got_b.values() for r in rs if r is not None]
    for r in runs:
        for k, c in r['launches'].items():
            counts[k] = counts.get(k, 0) + c
        for k, ds in r['designs'].items():
            for d, c in ds.items():
                designs.setdefault(k, {}).setdefault(d, 0)
                designs[k][d] += c
    return counts, designs


# ----------------------------------------------------------- pipeline
#: the pipeline phase: bert_12_768_12's 12 encoder cells (768 wide, 12
#: heads, 3072 hidden, no dropout) split into 4 stages of 3 over 4 ranks;
#: 8 microbatches of (8, 128, 768), squared error against seeded targets,
#: Adam 1e-4, 2 steps a schedule
PIPE = dict(cells=12, stages=4, micro=8, mb=8, seq=128, units=768,
            hidden=3072, heads=12, steps=2, dev='cuda')
if REHEARSE:
    PIPE.update(micro=4, mb=2, seq=8, units=32, hidden=64, heads=4,
                dev='cpu')


def _pipe_net(mx, bert, seed):
    from mxnet_tpu_torch.gluon import nn
    mx.random.seed(seed)
    net = nn.HybridSequential()
    for _ in range(PIPE['cells']):
        net.add(bert.BERTEncoderCell(PIPE['units'], PIPE['hidden'],
                                     PIPE['heads'], dropout=0.0))
    net.initialize(ctx=_ctxd(mx, PIPE['dev']))
    with mx.autograd.predict_mode():
        net(mx.np.zeros((PIPE['mb'], PIPE['seq'], PIPE['units'])))
    return net


def _pipe_data(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = (PIPE['micro'], PIPE['mb'], PIPE['seq'], PIPE['units'])
    return (rng.standard_normal(shape).astype('float32'),
            rng.standard_normal(shape).astype('float32') * 0.5)


def pipe_reference(torch, seed, path):
    """One process: the 12 cells eagerly over the same microbatches, the
    summed squared error, Adam over every parameter; saves the first
    step's gradients, the weights after the last step and the losses."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    with _ctxd(mx, PIPE['dev']):
        net = _pipe_net(mx, bert, seed)
        xs, ys = (mx.np.array(a) for a in _pipe_data(seed))
        params = net.collect_params()
        tr = gluon.Trainer(params, 'adam', dict(BERT_OPTS[0][2]))
        ref = {'losses': []}
        for s in range(PIPE['steps']):
            with mx.autograd.record():
                total = None
                for t in range(PIPE['micro']):
                    e = ((net(xs[t]) - ys[t]) ** 2).sum()
                    total = e if total is None else total + e
            total.backward()
            ref['losses'].append(total.item())
            if s == 0:
                ref['grads'] = {k: p.grad()._data.cpu().clone()
                                for k, p in params.items()}
            tr.step(PIPE['micro'] * PIPE['mb'])
            if s == 0:
                ref['weights'] = {k: p.data()._data.cpu().clone()
                                  for k, p in params.items()}
    torch.save(ref, path)
    return ref['losses']


def _pipe_first_step(torch, ref, mine, res):
    """Hold a stage's first step to one process's: the gradients within
    rtol 1e-4 and 1e-6 of each tensor's largest (the summation orders
    differ), the weights after Adam's update within rtol 1e-4 and a
    hundredth of lr. Adam divides each gradient by its own size, so an
    element whose gradient is under 1e-4 of its tensor's largest (within
    a hundred times the rounding the gradient check allows) may move
    anywhere within lr: those are counted and held to that. After the
    first step the weights differ there, and every later gradient with
    them: only the losses are held."""
    lr = BERT_OPTS[0][2]['learning_rate']
    res['ill'] = [0, 0]
    for k, p in mine.items():
        g, got = p.grad()._data, p.data()._data
        want_g = ref['grads'][k].to(g.device)
        err, ok = compare(torch, g, want_g, 1e-4,
                          1e-6 * float(want_g.abs().max()))
        res['grad_err'] = max(res['grad_err'], err)
        want = ref['weights'][k].to(got.device)
        a = want_g.abs()
        ill = (a < 1e-4 * float(a.max())) & (a != 0)
        err, ok_w = compare(torch, got[~ill], want[~ill], 1e-4, 1e-2 * lr)
        gap = float((got[ill] - want[ill]).abs().max()) \
            if bool(ill.any()) else 0.0
        res['ill'][0] += int(ill.sum())
        res['ill'][1] += ill.numel()
        res['weight_err'] = max(res['weight_err'], err)
        res['noise_gap'] = max(res.get('noise_gap', 0.0), gap)
        res['ok'] &= ok and ok_w and gap <= lr


def _pipe_rank(seed, ref_path):
    """One stage of the pipeline phase: both schedules, each from the
    seeded net; checks its stage's gradients and weights against the
    reference here and returns the errors, losses, ms and counts."""
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.kvstore import fusion
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.sharding import ShardingContext
    from mxnet_tpu_torch.sharding.context import local_group
    dev = PIPE['dev']
    if dev == 'cuda':
        full_fp32(torch)
    else:
        torch.set_num_threads(1)
    kernels.reset_launch_counts()
    rank = dist.get_rank()
    ref = torch.load(ref_path, weights_only=False)
    ctx = ShardingContext({'pp': PIPE['stages']},
                          group=local_group(range(PIPE['stages'])))
    out = {'rank': rank}
    with _ctxd(mx, dev):
        xs, ys = (mx.np.array(a) for a in _pipe_data(seed))
        for sched in ('1f1b', 'gpipe'):
            net = _pipe_net(mx, bert, seed)
            names = {id(p): k for k, p in net.collect_params().items()}
            tr = parallel.PipelineTrainer(
                net, ctx, example=xs[0], optimizer='adam',
                optimizer_params=dict(BERT_OPTS[0][2]), schedule=sched)
            mine = {names[id(p)]: p for p in tr._params}
            res = {'losses': [], 'ms': [], 'hops_ms': [], 'counts': [],
                   'grad_err': 0.0, 'weight_err': 0.0, 'ok': True}
            for s in range(PIPE['steps']):
                dist.barrier()
                fusion.reset_counters()
                before = kernels.launch_counts()
                _sync_all(torch, dev)
                t0 = time.perf_counter()
                res['losses'].append(tr.step(xs, ys))
                _sync_all(torch, dev)
                res['ms'].append((time.perf_counter() - t0) * 1e3)
                c = fusion.counters()
                res['hops_ms'].append(sum(c.get(k, [0, 0, 0.0])[2]
                                          for k in ('send', 'recv')) * 1e3)
                res['counts'].append(_counts_since(kernels, before))
                if s == 0:      # from the same weights: hold the step
                    _pipe_first_step(torch, ref, mine, res)
            res['params'] = len(mine)
            out[sched] = res
            del net, tr
    out['launches'] = kernels.launch_counts()
    out['designs'] = kernels.path_counts()
    return out


def phase_pipeline(torch, seed):
    """The pipeline phase: see the module docstring. Returns the ranks'
    summed launch counts, by kernel and by design."""
    from mxnet_tpu_torch.parallel import launch
    ELASTIC_DIR.mkdir(parents=True, exist_ok=True)
    path = ELASTIC_DIR / 'pipeline_ref.pt'
    t0 = time.perf_counter()
    losses = pipe_reference(torch, seed, path)
    log(f'[pipeline] one-process reference: {time.perf_counter() - t0:.1f} '
        f's, losses {losses}')
    if PIPE['dev'] == 'cuda':
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(_pipe_rank, PIPE['stages'], seed, str(path),
                         backend='gloo', timeout=900)
    log(f'[pipeline] {PIPE["stages"]} ranks on cuda:0 over gloo in '
        f'{time.perf_counter() - t0:.1f} s (spawn included)')
    per = PIPE['cells'] // PIPE['stages']
    want = {'fused_norm': 2 * per * PIPE['micro'],
            'flash_attention': per * PIPE['micro'], 'adam': 12 * per}
    counts, designs = dict.fromkeys(KERNELS, 0), {}
    for r in ranks:
        for sched in ('1f1b', 'gpipe'):
            res = r[sched]
            if not res['ok']:
                fail(f'pipeline: {sched} stage {r["rank"]}: gradients '
                     f'(max err {res["grad_err"]:.3g}) or weights (max err '
                     f'{res["weight_err"]:.3g}) part from one process')
            for got, ref in zip(res['losses'], losses):
                if abs(got - ref) > 1e-4 * abs(ref):
                    fail(f'pipeline: {sched} losses {res["losses"]}, one '
                         f'process {losses}')
            for c in res['counts']:
                if not REHEARSE and {k: c.get(k, 0) for k in want} != want:
                    fail(f'pipeline: {sched} stage {r["rank"]} launched '
                         f'{c} a step, want {want}')
        for k, c in r['launches'].items():
            counts[k] = counts.get(k, 0) + c
        for k, ds in r['designs'].items():
            for d, c in ds.items():
                designs.setdefault(k, {}).setdefault(d, 0)
                designs[k][d] += c
    for sched in ('1f1b', 'gpipe'):
        ms = [r[sched]['ms'][-1] for r in ranks]
        hops = [r[sched]['hops_ms'][-1] for r in ranks]
        log(f'[pipeline] {sched}: {PIPE["cells"]} BERT-base cells as '
            f'{PIPE["stages"]} stages of {per}, {PIPE["micro"]} microbatches '
            f'of ({PIPE["mb"]}, {PIPE["seq"]}, {PIPE["units"]}), Adam: losses '
            f'{ranks[0][sched]["losses"]} (one process {losses}), each '
            f'stage\'s first-step gradients within rtol 1e-4 (max err '
            f'{max(r[sched]["grad_err"] for r in ranks):.3g}) and weights '
            f'after it (max err '
            f'{max(r[sched]["weight_err"] for r in ranks):.3g}; '
            f'{sum(r[sched]["ill"][0] for r in ranks)} of '
            f'{sum(r[sched]["ill"][1] for r in ranks)} elements, whose '
            f'gradient fell under 1e-4 of its tensor\'s largest, within lr: '
            f'max gap '
            f'{max(r[sched].get("noise_gap", 0.0) for r in ranks):.3g}); '
            f'step host ms by stage {[round(x, 1) for x in ms]}, send/recv '
            f'host ms {[round(x, 1) for x in hops]} '
            f'({100 * sum(hops) / sum(ms):.1f} % of the stages\' steps: a '
            f'receive waits for the stage before it, the bubble included); '
            f'launches a step a stage {ranks[0][sched]["counts"][-1]}')
    return counts, designs


# ---------------------------------------------------------------- moe
#: the moe phase: Mixtral-8x7B's FFN widths (D 4096, F 14336, 8 experts,
#: top-2, capacity factor 1.25; the reference's tanh-approximated gelu),
#: T tokens over ep = 4 ranks, fp32
MOE = dict(T=4096, D=4096, F=14336, E=8, ep=4, scale=0.02, dev='cuda')
if REHEARSE:
    MOE.update(T=64, D=8, F=16, dev='cpu')


def _moe_weights(torch, seed, experts, dev):
    """The seeded weights: the router whole and the given experts' w_in
    and w_out (each expert from its own seed, so any rank draws its own)."""
    g = torch.Generator(device=dev)
    D, F, s = MOE['D'], MOE['F'], MOE['scale']

    def randn(seed_, *shape):
        g.manual_seed(seed_)
        return torch.randn(*shape, generator=g, device=dev) * s
    wg = randn(seed + 1, D, MOE['E'])
    w_in = torch.stack([randn(seed + 100 + e, D, F) for e in experts])
    w_out = torch.stack([randn(seed + 200 + e, F, D) for e in experts])
    return wg, w_in, w_out


def _moe_tokens(torch, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(MOE['T'], MOE['D'], generator=g, device=dev)


def _moe_rank(seed):
    """One rank of the moe phase: its tokens and experts, a warm-up and a
    timed forward and backward; returns its output, the timings and the
    gradients' finiteness."""
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.kvstore import fusion
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.sharding import ShardingContext
    from mxnet_tpu_torch.sharding.context import local_group
    from mxnet_tpu_torch.sharding.dispatch import Layout, shard
    from mxnet_tpu_torch.sharding.rules import PartitionSpec as P
    if MOE['dev'] == 'cuda':
        full_fp32(torch)
    else:
        torch.set_num_threads(1)
    kernels.reset_launch_counts()
    rank, ep = dist.get_rank(), MOE['ep']
    dev = torch.device(MOE['dev'], 0) if MOE['dev'] == 'cuda' \
        else torch.device('cpu')
    ctx = ShardingContext({'ep': ep}, group=local_group(range(ep)))
    el, tl = MOE['E'] // ep, MOE['T'] // ep
    wg, w_in, w_out = _moe_weights(torch, seed, range(rank * el,
                                                      (rank + 1) * el), dev)
    x = _moe_tokens(torch, seed, dev)[rank * tl:(rank + 1) * tl].clone()
    out = {'rank': rank, 'expert_bytes': (w_in.numel() + w_out.numel()) * 4}
    wg.requires_grad_(True)
    w_in.requires_grad_(True)
    w_out.requires_grad_(True)

    def nd(t, gshape):
        return shard(t, Layout(ctx, P('ep'), gshape))
    for it in range(2):
        for w in (wg, w_in, w_out):
            w.grad = None
        dist.barrier()
        fusion.reset_counters()
        _sync_all(torch, MOE['dev'])
        t0 = time.perf_counter()
        y, aux = parallel.moe_ffn(
            nd(x, (MOE['T'], MOE['D'])), wg,
            nd(w_in, (MOE['E'], MOE['D'], MOE['F'])),
            nd(w_out, (MOE['E'], MOE['F'], MOE['D'])), ctx)
        _sync_all(torch, MOE['dev'])
        t1 = time.perf_counter()
        a2a_f = fusion.counters().get('all_to_all', [0, 0, 0.0])[2]
        loss = (y._data ** 2).sum() / (MOE['T'] * MOE['D']) + \
            0.01 * aux / ep
        loss.backward()
        _sync_all(torch, MOE['dev'])
        t2 = time.perf_counter()
        c = fusion.counters().get('all_to_all', [0, 0, 0.0])
    out.update(fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3,
               a2a_fwd_ms=a2a_f * 1e3, a2a_ms=c[2] * 1e3, a2a_calls=c[0],
               a2a_bytes=c[1], aux=float(aux.detach()),
               y=y._data.detach().cpu(),
               finite=all(bool(torch.isfinite(w.grad).all()) and
                          float(w.grad.abs().sum()) > 0
                          for w in (wg, w_in, w_out)),
               peak=torch.cuda.max_memory_allocated() / 2**30
               if MOE['dev'] == 'cuda' else 0.0)
    out['launches'] = kernels.launch_counts()
    out['designs'] = kernels.path_counts()
    return out


def phase_moe(torch, seed):
    """The moe phase: see the module docstring. Returns the ranks' summed
    launch counts (no kernel of the port runs: the products are
    ``torch.matmul``/``bmm``, as the reference's are XLA einsums)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    ranks = launch.spawn(_moe_rank, MOE['ep'], seed, backend='gloo',
                         timeout=600)
    log(f'[moe] {MOE["ep"]} ranks on cuda:0 over gloo in '
        f'{time.perf_counter() - t0:.1f} s (spawn included)')
    dev = torch.device('cuda', 0) if MOE['dev'] == 'cuda' \
        else torch.device('cpu')
    wg, w_in, w_out = _moe_weights(torch, seed, range(MOE['E']), dev)
    x = _moe_tokens(torch, seed, dev)
    tl = MOE['T'] // MOE['ep']
    worst = 0.0
    with torch.no_grad():
        for r in ranks:
            want, _ = parallel.moe_ffn(x[r['rank'] * tl:(r['rank'] + 1) * tl],
                                       wg, w_in, w_out, None)
            want = want._data
            err, ok = compare(torch, r['y'].to(dev), want, 1e-5,
                              1e-5 * float(want.abs().max()))
            worst = max(worst, err)
            if not ok or not r['finite']:
                fail(f'moe: rank {r["rank"]}: output against ep = 1 max err '
                     f'{err:.3g} (ok {ok}), gradients finite {r["finite"]}')
    del wg, w_in, w_out, x
    if MOE['dev'] == 'cuda':
        torch.cuda.empty_cache()
    r0 = ranks[0]
    tot = r0['fwd_ms'] + r0['bwd_ms']
    log(f'[moe] Mixtral-8x7B FFN widths (D {MOE["D"]}, F {MOE["F"]}, E '
        f'{MOE["E"]}, top-2, cf 1.25), T {MOE["T"]} over ep {MOE["ep"]}, '
        f'fp32: experts {r0["expert_bytes"] / 1e9:.3f} GB a rank; output '
        f'within rtol 1e-5 of each token shard through ep = 1 (max err '
        f'{worst:.3g}); gradients finite; aux {r0["aux"]:.6f}; rank 0 '
        f'forward {r0["fwd_ms"]:.1f} ms, backward {r0["bwd_ms"]:.1f} ms, '
        f'all_to_all {r0["a2a_ms"]:.1f} ms of them '
        f'({100 * r0["a2a_ms"] / tot:.1f} %; {r0["a2a_calls"]} exchanges '
        f'of {r0["a2a_bytes"] / r0["a2a_calls"] / 1e6:.1f} MB, forward '
        f'{r0["a2a_fwd_ms"]:.1f} ms); by rank forward '
        f'{[round(r["fwd_ms"], 1) for r in ranks]}, backward '
        f'{[round(r["bwd_ms"], 1) for r in ranks]} ms; peak '
        f'{[round(r["peak"], 2) for r in ranks]} GiB')
    counts, designs = dict.fromkeys(KERNELS, 0), {}
    for r in ranks:
        for k, c in r['launches'].items():
            counts[k] = counts.get(k, 0) + c
    return counts, designs


# ------------------------------------------------------------------ sparse
#: the sparse phase: (a) ``examples/sparse_embedding.py`` at its own sizes,
#: (b) one table at deployment scale, (c) the oracle's CSR at scale
SPARSE = dict(rows=1_000_000, dim=16, batch=512, steps=40,
              big_rows=10_000_000, big_dim=64, big_ids=8192, big_steps=10,
              zipf=1.1, pull=1024, csr_rows=10_000_000, csr_cols=512,
              mem_mb=64, dev='cuda')
#: (a)'s three runs: optimizer, its settings, the kernel each sparse table's
#: update must launch once a step (AdaGrad's update is plain PyTorch, as the
#: reference leaves it to XLA), and the relative limits of the card's losses
#: and of its touched rows against the host run. AdaGrad at lr 0.5 drives
#: the loss to 1e-5, where the host parts from itself by 4.45e-05 (losses)
#: and 7.09e-04 (rows) when each 16-term sum is only reversed: its limits
#: are about four times those gaps
SPARSE_RUNS = (('adagrad', {'learning_rate': 0.5}, None, (3e-4, 3e-3)),
               ('adam', {'learning_rate': 0.01, 'lazy_update': True},
                'adam', (1e-5, 1e-5)),
               ('sgd', {'learning_rate': 0.5, 'momentum': 0.9,
                        'lazy_update': True}, 'sgd_mom', (1e-5, 1e-5)))
#: the control of each run of (a): the host run with the learning rate
#: moved by this much (relative) must fail the check against the host run
SPARSE_CONTROL_LR = 1e-4


if REHEARSE:
    SPARSE.update(rows=2000, batch=64, steps=4, big_rows=5000, big_dim=8,
                  big_ids=256, big_steps=3, pull=16, csr_rows=20_000,
                  csr_cols=64, dev='cpu')


def _mf_run(mx, opt, kw, tables, u, i, y, steps, reorder=False):
    """The matrix-factorization program of ``examples/sparse_embedding.py``
    through the port in the current context: two row-sparse embedding
    tables from ``tables``, ``steps`` Trainer steps on one batch. Returns
    the nets, the Trainer, the losses (tensors), the host seconds a step
    over steps 2 on (ended by a sync) and the last gradient. ``reorder`` sums each
    row's products in the reverse order (the same function, rounded in
    another order: what two summation orders alone part by)."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    nets = []
    for w in tables:
        net = gluon.nn.Embedding(w.shape[0], w.shape[1], sparse_grad=True)
        net.initialize()
        net.weight.set_data(mx.np.array(w))
        nets.append(net)
    params = {f'{k}_{n}': p for k, net in zip('ui', nets)
              for n, p in net.collect_params().items()}
    tr = gluon.Trainer(params, opt, dict(kw), kvstore=None)
    u, i, y = mx.np.array(u), mx.np.array(i), mx.np.array(y)
    losses = []
    dev = nets[0].weight._var.device.type
    for s in range(steps):
        if s == 1:      # the first step loads the card's code: not timed
            _sync_all(torch, dev)
            t0 = time.perf_counter()
        with autograd.record():
            prod = nets[0](u) * nets[1](i)
            pred = (prod[:, ::-1] if reorder else prod).sum(-1)
            loss = ((pred - y) ** 2).mean()
        loss.backward()
        tr.step(1)
        losses.append(loss._data.detach())
    _sync_all(torch, dev)
    secs = (time.perf_counter() - t0) / (steps - 1)
    return nets, tr, losses, secs, nets[0].weight.grad()


def _mf_gaps(torch, run, ref, ids):
    """How far ``run`` parts from ``ref`` (two results of ``_mf_run``):
    each step's loss as a relative gap, and over the touched rows of both
    tables and of their slots the largest gap past atol 1e-6 relative to
    the reference value."""
    lr = torch.stack([x.cpu() for x in run[2]]).double()
    lf = torch.stack([x.cpu() for x in ref[2]]).double()
    loss_rel = ((lr - lf).abs() / lf.abs()).tolist()
    row_rel = row_abs = 0.0
    for k, idx in enumerate(ids):
        touched = torch.unique(torch.as_tensor(idx, dtype=torch.int64))
        for got, want in zip(_mf_tensors(run, k), _mf_tensors(ref, k)):
            g = got[touched.to(got.device)].cpu().double()
            w = want[touched.to(want.device)].cpu().double()
            e = (g - w).abs()
            row_abs = max(row_abs, float(e.max()))
            row_rel = max(row_rel, float(((e - 1e-6).clamp_min(0)
                                          / w.abs().clamp_min(1e-30))
                                         .max()))
    return dict(loss_rel=loss_rel, loss_max=max(loss_rel),
                row_rel=row_rel, row_abs=row_abs)


def _mf_tensors(res, k):
    """Table ``k``'s weight and its optimizer slots in a ``_mf_run``
    result."""
    from mxnet_tpu_torch.optimizer import _flat_slots
    nets, tr = res[0], res[1]
    p = nets[k].weight
    j = next(j for j, q in enumerate(tr._params) if q is p)
    w = p.data()._data.detach()
    return [w] + _flat_slots(tr._states.get(j), w.shape[0])


def _mf_untouched(torch, what, res, tables, ids):
    """Fail unless every row no id names, of both tables and of their
    slots, is bit-equal to its start (slots start at zero)."""
    for k, (w0, idx) in enumerate(zip(tables, ids)):
        got = _mf_tensors(res, k)
        dev = got[0].device
        untouched = torch.ones(w0.shape[0], dtype=torch.bool, device=dev)
        untouched[torch.as_tensor(idx, dtype=torch.int64).to(dev)] = False
        if not torch.equal(got[0][untouched],
                           torch.as_tensor(w0).to(dev)[untouched]):
            fail(f'sparse (a) {what}: table {k} rows no id names moved')
        for s_ in got[1:]:
            if bool((s_[untouched] != 0).any()):
                fail(f'sparse (a) {what}: a slot of table {k} moved on '
                     f'untouched rows')


def _sparse_examples(torch, mx, seed):
    """(a): see the module docstring."""
    import numpy as np
    from mxnet_tpu_torch.ndarray import sparse as sp
    from mxnet_tpu_torch.ops import kernels
    c = SPARSE
    rng = np.random.default_rng(seed)
    tables = [(rng.standard_normal((c['rows'], c['dim'])) * 0.1).astype(
        np.float32) for _ in range(2)]
    u = rng.integers(0, c['rows'], c['batch'])
    i = rng.integers(0, c['rows'], c['batch'])
    y = rng.uniform(0.5, 1.5, c['batch']).astype(np.float32)
    out, problems = {}, []
    card_ctx = _ctxd(mx, c['dev'])
    for opt, kw, kern, (tol_l, tol_r) in SPARSE_RUNS:
        before = kernels.launch_counts()
        with card_ctx:
            card = _mf_run(mx, opt, kw, tables, u, i, y, c['steps'])
        after = kernels.launch_counts()
        moved = dict(kw, learning_rate=kw['learning_rate'] * (
            1 + SPARSE_CONTROL_LR))
        with mx.cpu():
            host = _mf_run(mx, opt, kw, tables, u, i, y, c['steps'])
            again = _mf_run(mx, opt, kw, tables, u, i, y, c['steps'],
                            reorder=True)
            ctl = _mf_run(mx, opt, moved, tables, u, i, y, c['steps'])
        g = card[4]
        per = {k: (after[k] - before[k]) / c['steps'] for k in
               ('adam', 'sgd_mom')}
        want = {k: (2.0 if k == kern else 0.0) for k in per}
        if per != want and not REHEARSE:
            fail(f'sparse (a) {opt}: launches a step {per}, want {want}')
        if not isinstance(g, sp.RowSparseNDArray) or \
                g.data.shape[0] > c['batch']:
            fail(f'sparse (a) {opt}: the gradient is {type(g).__name__} '
                 f'of {getattr(g, "data", g).shape} entries')
        _mf_untouched(torch, opt, card, tables, (u, i))
        _mf_untouched(torch, opt, host, tables, (u, i))
        gap = _mf_gaps(torch, card, host, (u, i))
        noise = _mf_gaps(torch, again, host, (u, i))    # printed only
        control = _mf_gaps(torch, ctl, host, (u, i))
        if control['loss_max'] <= tol_l and control['row_rel'] <= tol_r:
            problems.append(
                f'{opt}: the control (lr x (1 + {SPARSE_CONTROL_LR:g})) '
                f'passes: it parts from the host run by only '
                f'{control["loss_max"]:.3g} (losses) and '
                f'{control["row_rel"]:.3g} (rows), within the limits '
                f'{tol_l:g} and {tol_r:g}')
        if gap['loss_max'] > tol_l or gap['row_rel'] > tol_r:
            first = next((j for j, e in enumerate(gap['loss_rel'])
                          if e > 1e-5), None)
            problems.append(
                f'{opt}: card against host: losses {gap["loss_max"]:.3g} '
                f'(rtol {tol_l:.3g}; first past 1e-5 at step {first}), '
                f'rows {gap["row_rel"]:.3g} (rtol {tol_r:.3g}); host '
                f'reordered against host: losses {noise["loss_max"]:.3g}, '
                f'rows {noise["row_rel"]:.3g}')
        lerr, werr = gap['loss_max'], gap['row_rel']
        out[opt] = dict(step_ms=1e3 * card[3],
                        host_cpu_step_ms=1e3 * host[3],
                        per_step=per, entries=int(g.data.shape[0]),
                        grad=type(g).__name__,
                        loss0=float(card[2][0]), loss=float(card[2][-1]),
                        loss_err=lerr, row_err=werr,
                        sparse_updates=card[1].sparse_update_count,
                        tol_loss=tol_l, tol_row=tol_r,
                        noise_loss=noise['loss_max'],
                        noise_row=noise['row_rel'],
                        control_loss=control['loss_max'],
                        control_row=control['row_rel'],
                        loss_rel=gap['loss_rel'],
                        noise_loss_rel=noise['loss_rel'])
        log(f'[sparse] (a) {opt} {kw}: 2 x Embedding({c["rows"]:,}, '
            f'{c["dim"]}, sparse_grad=True), batch {c["batch"]}, '
            f'{c["steps"]} steps: mse {out[opt]["loss0"]:.5f} -> '
            f'{out[opt]["loss"]:.5f}; gradient {out[opt]["grad"]} of '
            f'{out[opt]["entries"]} entries; B5 {per["adam"]:g} and B6 '
            f'{per["sgd_mom"]:g} launches a step; host {out[opt]["step_ms"]:.3f}'
            f' ms a step on the card over steps 2-{c["steps"]} (the same '
            f'program on the host CPU {out[opt]["host_cpu_step_ms"]:.3f}); '
            f'against the host run: '
            f'losses within {lerr:.3g} relative (rtol {tol_l:.3g}), touched '
            f'rows and slots within {werr:.3g} relative past atol 1e-6 '
            f'(rtol {tol_r:.3g}); the host run with each 16-term sum '
            f'reversed: {noise["loss_max"]:.3g} and {noise["row_rel"]:.3g}; '
            f'the control, lr x (1 + {SPARSE_CONTROL_LR:g}): '
            f'{control["loss_max"]:.3g} and {control["row_rel"]:.3g}; '
            f'untouched rows bit-equal')
        log(f'[sparse] (a) {opt} relative loss gaps by step, card: '
            f'{[float(f"{e:.2g}") for e in gap["loss_rel"]]}; reversed '
            f'sums: {[float(f"{e:.2g}") for e in noise["loss_rel"]]}')
        if opt == 'adagrad':
            users = card[0][0]
            with card_ctx:
                kv = mx.kvstore.create('device')
                kv.init('users', users.weight.data())
                pulled = kv.row_sparse_pull('users',
                                            row_ids=mx.np.array(u[:4]))
            if not isinstance(pulled, sp.RowSparseNDArray) or \
                    tuple(pulled.data.shape) != (4, c['dim']) or \
                    not torch.equal(pulled.data._data, users.weight.data()
                                    ._data[torch.as_tensor(u[:4]).to(
                                        pulled.data._data.device)]):
                fail(f'sparse (a): row_sparse_pull gave '
                     f'{type(pulled).__name__} {pulled.data.shape}')
            log(f'[sparse] (a) row_sparse_pull of 4 rows from a \'device\' '
                f'kvstore: {type(pulled).__name__}, data '
                f'{tuple(pulled.data.shape)}')
            del kv, pulled, users
        del card, host, again, ctl, g
        _empty_cache(torch)
    if problems:
        out['problems'] = problems
    return out


def _empty_cache(torch):
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _memory(torch, dev, peak=False):
    """Bytes allocated on the card (the peak since the last reset with
    ``peak``), after a sync; 0 on the host (a rehearsal)."""
    if dev != 'cuda':
        return 0
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() if peak else \
        torch.cuda.memory_allocated()


def _reset_peak(torch, dev):
    if dev == 'cuda':
        torch.cuda.reset_peak_memory_stats()


def _sparse_big(torch, mx, seed):
    """(b): see the module docstring."""
    import numpy as np
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ndarray import sparse as sp
    from mxnet_tpu_torch.ops import kernels
    c = SPARSE
    N, D, n = c['big_rows'], c['big_dim'], c['big_ids']
    limit = c['mem_mb'] * 2 ** 20
    mx.random.seed(seed)
    rng = np.random.default_rng(seed)
    card_ctx = _ctxd(mx, c['dev'])
    with card_ctx:
        emb = gluon.nn.Embedding(N, D, sparse_grad=True)
        emb.initialize(init=mx.init.Normal(0.1))
        w0 = emb.weight.data()._data.detach().clone()
        tr = gluon.Trainer(emb.collect_params(), 'adam',
                           {'learning_rate': 0.01, 'lazy_update': True},
                           kvstore=None)
        batches = [((rng.zipf(c['zipf'], n) - 1) % N,
                    rng.standard_normal(n).astype(np.float32))
                   for _ in range(c['big_steps'])]
        ids = [mx.np.array(b[0]) for b in batches]
        ys = [mx.np.array(b[1]) for b in batches]
    dev = w0.device

    def step(s):
        with autograd.record():
            out = emb(ids[s])
            loss = ((out.sum(-1) - ys[s]) ** 2).mean()
        loss.backward()
        tr.step(1)

    b5 = kernels.launch_counts()['adam']
    step(0)
    level = _memory(torch, c['dev'])
    _reset_peak(torch, c['dev'])
    t0 = time.perf_counter()
    for s in range(1, c['big_steps']):
        step(s)
    _sync_all(torch, c['dev'])
    step_ms = 1e3 * (time.perf_counter() - t0) / (c['big_steps'] - 1)
    rise = _memory(torch, c['dev'], peak=True) - level
    b5 = kernels.launch_counts()['adam'] - b5
    merged = [len(np.unique(b[0])) for b in batches]
    if rise > limit:
        fail(f'sparse (b): steps 2-{c["big_steps"]} allocated '
             f'{rise / 2**20:.1f} MB past the level after step 1 (limit '
             f'{c["mem_mb"]} MB)')
    if b5 != c['big_steps'] and not REHEARSE:
        fail(f'sparse (b): {b5} B5 launches in {c["big_steps"]} steps')
    touched = torch.zeros(N, dtype=torch.bool, device=dev)
    for b in batches:
        touched[torch.as_tensor(b[0], device=dev)] = True
    w = emb.weight.data()._data.detach()
    moved = (w != w0).any(1)
    if bool((moved & ~touched).any()):
        fail('sparse (b): a row no id names moved')
    if not bool(moved[touched].all()):
        log('[sparse] (b) note: some touched rows did not move')
    del w0, moved
    # the pull: the store's init copies the table; the pull itself must
    # stay under the same limit
    with card_ctx:
        kv = mx.kvstore.create('device')
        kv.init('emb', emb.weight.data())
        rows = mx.np.array(batches[0][0][:c['pull']])
        level = _memory(torch, c['dev'])
        _reset_peak(torch, c['dev'])
        pulled = kv.row_sparse_pull('emb', row_ids=rows)
    pull_rise = _memory(torch, c['dev'], peak=True) - level
    if pull_rise > limit or not isinstance(pulled, sp.RowSparseNDArray) or \
            tuple(pulled.data.shape) != (c['pull'], D):
        fail(f'sparse (b): row_sparse_pull of {c["pull"]} rows gave '
             f'{type(pulled).__name__} {tuple(pulled.data.shape)} and '
             f'allocated {pull_rise / 2**20:.1f} MB')
    if not torch.equal(pulled.data._data, w[rows._data.long()]):
        fail('sparse (b): the pulled rows are not the table\'s')
    del kv, pulled, w, emb, tr, touched
    _empty_cache(torch)
    out = dict(step_ms=step_ms, rise_mb=rise / 2 ** 20,
               pull_rise_mb=pull_rise / 2 ** 20, b5=b5, merged=merged)
    log(f'[sparse] (b) Embedding({N:,}, {D}, sparse_grad=True), Adam '
        f'lazy, {c["big_steps"]} steps of {n} ids drawn Zipf({c["zipf"]}) '
        f'(distinct ids a step {min(merged)}-{max(merged)}): host '
        f'{step_ms:.3f} ms a step over steps 2-{c["big_steps"]}; memory '
        f'past the level after step 1 {out["rise_mb"]:.2f} MB (limit '
        f'{c["mem_mb"]} MB); {b5} B5 launches; rows no id named bit-equal; '
        f'row_sparse_pull of {c["pull"]} rows: RowSparseNDArray '
        f'({c["pull"]}, {D}), {out["pull_rise_mb"]:.2f} MB allocated')
    return out


def sparse_rows(torch, seed):
    """B5 at the sparse phase's (b) merged-row shape against its plain
    version, timed beside its bound and ``torch.optim``'s fused Adam:
    the static-size merge hands the kernel one row an id, 8192 x 64.
    Outside the phase's window: these launches compare, they are not the
    main path's."""
    from mxnet_tpu_torch.ops.kernels import fused_optimizer as fo
    n, D = SPARSE['big_ids'], SPARSE['big_dim']
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, D)
    wr, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    m = torch.randn(shape, generator=gen, device=dev) * 0.1
    v = (torch.randn(shape, generator=gen, device=dev) * 0.1).square()
    vec = torch.tensor([0.01, 0.0, 1 - 0.9 ** 5, 1 - 0.999 ** 5],
                       device=dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)
    ks = [x.clone() for x in (wr, m, v)]
    ps = [x.clone() for x in (wr, m, v)]
    got = fo.adam_step(ks[0], g, ks[1], ks[2], vec, **kw)
    want = fo.adam_step_plain(ps[0], g, ps[1], ps[2], vec, **kw)
    p = torch.nn.Parameter(wr.clone())
    p.grad = g
    adam = torch.optim.Adam([p], lr=0.01, fused=True)
    row = _case(torch, 'adam', f'({n}, {D}) t=5, the merged rows of (b)',
                got, want, (1e-6, 1e-7),
                'fp32, the same operations in the same order, none '
                'contracted',
                lambda: fo.adam_step(ks[0], g, ks[1], ks[2], vec, **kw),
                lambda: fo.adam_step_plain(ps[0], g, ps[1], ps[2], vec,
                                           **kw),
                28 * n * D, 18 * n * D, adam.step,
                library_call='torch.optim.Adam(fused=True).step')
    if not row['ok']:
        fail('sparse (b): B5 at the merged-row shape parts from its plain '
             'version')
    log(f'[sparse] B5 at ({n}, {D}), the merged rows of (b): '
        f'{row["ms"]:.4f} ms for {28 * n * D / 1e6:.2f} MB (bound '
        f'{row["bound_ms"]:.4f} ms at 3.35 TB/s, '
        f'{100 * row["bound_ms"] / row["ms"]:.0f} %; L2-warm: the '
        f'{28 * n * D / 1e6:.1f} MB fit the 50 MB L2)')
    return row


def _sparse_csr(torch, mx, seed):
    """(c): see the module docstring."""
    import numpy as np
    from mxnet_tpu_torch.ndarray import sparse as sp
    sys.path.insert(0, str(ROOT / 'tests'))
    from torch_a3_cases import scipy_like_csr
    c = SPARSE
    R, C = c['csr_rows'], c['csr_cols']
    rng = np.random.default_rng(seed)
    data, indptr, cols, rows = scipy_like_csr(rng, R, C, 2)
    nnz = len(data)
    dev = torch.device('cuda', 0) if c['dev'] == 'cuda' else \
        torch.device('cpu')
    csr = sp.CSRNDArray(torch.from_numpy(data).to(dev),
                        torch.from_numpy(indptr).to(dev),
                        torch.from_numpy(cols).to(dev), (R, C))
    v = rng.standard_normal(C).astype(np.float32)
    with _ctxd(mx, c['dev']):
        vd = mx.nd.array(v)
        out = sp.dot(csr, vd)
        got = out.asnumpy()
        out_t = sp.dot(csr, out, transpose_a=True)
        got_t = out_t.asnumpy()
    for r in (0, min(123, R - 1), R - 1):
        lo, hi = indptr[r], indptr[r + 1]
        want = float((data[lo:hi].astype(np.float64)
                      * v[cols[lo:hi]]).sum())
        if not abs(got[r] - want) <= 1e-4 + 3e-4 * abs(want):
            fail(f'sparse (c): row {r} of csr . v is {got[r]}, host {want}')
    want_t = np.bincount(cols, weights=data.astype(np.float64) * got[rows],
                         minlength=C)
    for col in (0, min(123, C - 1), C - 1):
        if not abs(got_t[col] - want_t[col]) <= 1e-3 + 3e-4 * abs(
                want_t[col]):
            fail(f'sparse (c): column {col} of csr^T . out is '
                 f'{got_t[col]}, host {want_t[col]}')
    if csr.__dict__.get('_dense') is not None:
        fail('sparse (c): the CSR array was made dense')
    half = (csr * 0.5)[R // 2:R // 2 + 100]
    if half.shape != (100, C) or half.data.shape[0] > 400 or \
            csr.__dict__.get('_dense') is not None:
        fail('sparse (c): scalar math and row slicing left O(nnz) storage')
    timed = (eager_ms if c['dev'] == 'cuda' else
             lambda torch, fn, budget_ms: math.nan)
    ms = timed(torch, lambda: sp.dot(csr, vd), budget_ms=200.0)
    ms_t = timed(torch, lambda: sp.dot(csr, out, transpose_a=True),
                 budget_ms=200.0)
    # each input read once, each output written once
    nbytes = 4 * nnz + 8 * nnz + 8 * (R + 1) + 4 * C + 4 * R
    bnd, _ = bound(nbytes, 2 * nnz)
    log(f'[sparse] (c) CSR ({R:,} x {C}), {nnz:,} stored values (dense '
        f'fp32 would be {4 * R * C / 1e9:.1f} GB): csr . v {ms:.4f} ms, '
        f'csr^T . out {ms_t:.4f} ms, each against a bound of {bnd:.4f} ms '
        f'for {nbytes / 1e6:.0f} MB at 3.35 TB/s; rows 0, 123, {R - 1:,} and '
        f'columns 0, 123, {C - 1} at the host\'s values; _dense never set; '
        f'(csr * 0.5)[{R // 2:,}:{R // 2 + 100:,}] holds '
        f'{half.data.shape[0]} values')
    del csr, out, out_t, vd, half
    _empty_cache(torch)
    return dict(nnz=nnz, ms=ms, ms_t=ms_t, bound_ms=bnd)


def _case_outs(mx, name, args, kw, ctx):
    """The outputs (tensors) of op ``name`` on the case's inputs in
    ``ctx``."""
    import numpy as np

    def conv(a):
        if isinstance(a, np.ndarray):
            return mx.np.array(a)
        if isinstance(a, list):
            return [conv(e) for e in a]
        return a
    with ctx:
        fn = getattr(mx.npx, name, None) or getattr(mx.np, name, None) or \
            getattr(mx.nd, name)
        out = fn(*[conv(a) for a in args], **kw)
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [o._data for o in outs]


def _invariants(torch, name, outs, args):
    """What of a factorization is unique: eigenvalues and the matrix
    rebuilt from its factors; sorted eigenvalues of ``eig``."""
    import numpy as np
    if name in ('linalg_eig', 'linalg_eigvals'):
        vals = np.sort_complex(outs[0].detach().cpu().numpy().astype(
            np.complex128))
        return [torch.from_numpy(vals.real.copy()),
                torch.from_numpy(vals.imag.copy())]
    o = [x.detach().cpu().double() for x in outs]
    if name in ('linalg_eigh', 'linalg_syevd'):
        w, v = o
        return [w, v @ torch.diag(w) @ v.T]
    if name == 'linalg_svd':
        u, s, vh = o
        k = s.shape[0]
        return [s, (u[:, :k] * s) @ vh[:k]]
    q, r = o        # qr, gelqf
    return [q @ r, r.abs()]


def _sparse_ops(torch, mx, seed):
    """(d): see the module docstring. The loop block: a Dense layer, then
    ``foreach``, and with ``host_stop`` ``cond`` and ``while_loop``."""
    import numpy as np
    sys.path.insert(0, str(ROOT / 'tests'))
    import torch_a3_cases as cases
    from mxnet_tpu_torch import autograd, gluon
    host, card = mx.cpu(), _ctxd(mx, SPARSE['dev'])
    exercised, worst, n_out = set(), 0.0, 0
    groups = [(cases.LINALG_PRODUCTS, 1e-5, 1e-5),
              (cases.LINALG_TRIANGULAR, 1e-4, 1e-5),
              (cases.LINALG_SOLVERS, 1e-4, 1e-5),
              (cases.EXTRAS, 1e-5, 1e-5), (cases.LEGACY, 1e-5, 1e-5),
              (cases.CONTRIB, 1e-5, 1e-5),
              ([('fft_' + n, (x,), kw) for n, x, kw in cases.FFT], 1e-5,
               1e-5),
              (cases.MISC, 1e-5, 1e-5), (cases.FACTORS, 1e-4, 1e-4)]
    factors = {f[0] for f in cases.FACTORS}
    for group, rtol, atol in groups:
        for name, args, kw in group:
            want = _case_outs(mx, name, args, kw, host)
            got = _case_outs(mx, name, args, kw, card)
            on_host = [i for i, g in enumerate(got)
                       if g.device.type != SPARSE['dev']]
            if on_host:
                fail(f'sparse (d): {name} left outputs {on_host} on the '
                     f'host')
            n_out += len(got)
            if name in factors:
                got = _invariants(torch, name, got, args)
                want = _invariants(torch, name, want, args)
            for g, w in zip(got, want):
                g = g.detach().cpu()
                if g.is_complex():
                    g, w = torch.view_as_real(g), torch.view_as_real(w)
                if g.dtype != w.dtype or g.shape != w.shape:
                    fail(f'sparse (d): {name}: card {g.dtype} '
                         f'{tuple(g.shape)}, host {w.dtype} '
                         f'{tuple(w.shape)}')
                if g.is_floating_point():
                    tol = atol * max(1.0, float(w.abs().max())) \
                        if name.startswith('fft_') else atol
                    fin = torch.isfinite(w)
                    ok = torch.equal(fin, torch.isfinite(g)) and bool(
                        ((g[fin].double() - w[fin].double()).abs() <=
                         tol + rtol * w[fin].double().abs()).all())
                    err = float((g[fin].double() - w[fin].double()).abs()
                                .max()) if fin.any() else 0.0
                else:
                    ok, err = torch.equal(g, w), 0.0
                worst = max(worst, err)
                if not ok:
                    fail(f'sparse (d): {name}{kw}: the card parts from the '
                         f'host (max err {err:.3g}, rtol {rtol}, atol '
                         f'{atol})')
            exercised.add(name)
    for name, kw, mean, var in cases.SAMPLERS:
        with card:
            mx.random.seed(seed)
            fn = getattr(mx.npx, name)
            x = fn(shape=(20_000,), **kw) if name.startswith('sample_') \
                else fn(size=20_000, **kw)
        if x._data.device.type != SPARSE['dev']:
            fail(f'sparse (d): {name} drew on the host')
        ok, zm, zv = cases.moments_ok(x.asnumpy(), mean, var)
        if not ok:
            fail(f'sparse (d): {name} {kw}: mean {zm:.2f} and variance '
                 f'{zv:.2f} standard errors off')
        exercised.add(name)
    missing = sorted(set(cases.A3_NAMES) - exercised)
    if missing:
        fail(f'sparse (d): A3 names not run on the card: {missing}')
    log(f'[sparse] (d) {len(exercised)} op names on the card (every A3 '
        f'name), {n_out} outputs, every one a CUDA tensor; against the '
        f'host at each case\'s tolerance, max err {worst:.3g}; the eight '
        f'gamma-family samplers at their moments (n = 20,000, 5 standard '
        f'errors)')

    class Loops(gluon.HybridBlock):
        def __init__(self, host_stop):
            super().__init__()
            self.host_stop = host_stop
            self.dense = gluon.nn.Dense(3, in_units=3)

        def forward(self, x):
            def body(v, states):
                acc = states[0] + v
                return acc, [acc]
            h = self.dense(x)
            outs, (acc,) = mx.npx.foreach(body, h, [h[0] * 0])
            if not self.host_stop:
                return outs
            y = mx.npx.cond(acc.sum() > -1e9, lambda a: a * 2.0,
                            lambda a: a, [outs])
            _, (_, z) = mx.npx.while_loop(
                lambda i, z: i < 2, lambda i, z: (z, (i + 1, z + 1.0)),
                (mx.np.array(0), y), max_iterations=4)
            return z

    x = np.random.default_rng(seed).standard_normal((4, 3)).astype('f')
    figures = {}
    for host_stop in (False, True):
        with card:
            net = Loops(host_stop)
            net.initialize()
            xd = mx.np.array(x)
            eager = net(xd)._data.clone()
            net.hybridize()
            outs = []
            for _ in range(2):
                outs.append(net(xd)._data.clone())
                with autograd.record():
                    loss = net(xd).sum()
                loss.backward()
            _sync_all(torch, SPARSE['dev'])
        for o in outs:
            err, ok = compare(torch, o, eager, 1e-6, 1e-6)
            if not ok:
                fail(f'sparse (d): the hybridized control-flow block parts '
                     f'from its eager call (host_stop {host_stop})')
        figures[host_stop] = (net.capture_count, net.eager_call_count)
        if host_stop and net.eager_call_count == 0 and not REHEARSE:
            fail('sparse (d): a host-stopped loop was captured')
    log(f'[sparse] (d) control flow in a hybridized block on the card, two '
        f'predict and two recorded calls each: foreach alone '
        f'capture_count {figures[False][0]}, eager_call_count '
        f'{figures[False][1]}; with cond and while_loop (decided on the '
        f'host) capture_count {figures[True][0]}, eager_call_count '
        f'{figures[True][1]}; outputs equal to the eager calls')
    return dict(ops=len(exercised), outputs=n_out, worst=worst,
                control_flow=figures)


def phase_sparse(torch, seed):
    """The sparse phase: see the module docstring. Returns its numbers."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    got = {'a': _sparse_examples(torch, mx, seed)}
    t_a = time.perf_counter()
    got['b'] = _sparse_big(torch, mx, seed + 1)
    t_b = time.perf_counter()
    got['c'] = _sparse_csr(torch, mx, seed + 2)
    t_c = time.perf_counter()
    got['d'] = _sparse_ops(torch, mx, seed + 3)
    if got['a'].get('problems'):
        fail('sparse (a): past the tolerance: ' +
             '; '.join(got['a']['problems']))
    card = 'host (a rehearsal)' if REHEARSE else smi_line()
    log(f'[sparse] {card}; (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} '
        f's, (c) {t_c - t_b:.1f} s, (d) {time.perf_counter() - t_c:.1f} s')
    return got


# ------------------------------------------------------------------ symbol
#: the symbol phase's files (build/ is git-ignored) and sizes: BERT-base at
#: the bert phase's batch, ResNet-50 at the resnet phase's; (b) holds the
#: card to the host on the first SYMBOL_BF16_ROWS sequences
SYMBOL_DIR = ROOT / 'build' / 'symbol'
SYMBOL = dict(dev='cuda', bert_kw={}, batch=BERT_BATCH, seq=BERT_SEQ,
              vocab=BERT_VOCAB, resnet='resnet50_v1', images=32, side=224)
SYMBOL_BF16_ROWS = 2
if REHEARSE:
    SYMBOL.update(dev='cpu', bert_kw=_TINY_BERT, batch=4, seq=16, vocab=100,
                  resnet='resnet18_v1', images=2, side=32)


def _outs(res):
    return list(res) if isinstance(res, (tuple, list)) else [res]


def _equal_outs(torch, what, got, want, rtol):
    """Bit-equal, else within ``rtol`` of the largest |want| (logged):
    True when bit-equal."""
    got, want = _outs(got), _outs(want)
    same = len(got) == len(want) and all(
        torch.equal(g._data, w._data) for g, w in zip(got, want))
    if same:
        return True
    gaps = [float((g._data.double() - w._data.double()).abs().max()
                  / w._data.double().abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]
    log(f'[symbol] {what}: not bit-equal; largest gap over the largest '
        f'|value| {gaps} (limit {rtol})')
    if not all(math.isfinite(x) and x <= rtol for x in gaps):
        fail(f'symbol: {what} parts from its reference: {gaps}')
    return False


def _predict_ms(torch, dev, call, n=3):
    """Host ms of ``n`` synced calls."""
    out = []
    for _ in range(n):
        _sync_all(torch, dev.type)
        t0 = time.perf_counter()
        call()
        _sync_all(torch, dev.type)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _symbol_bert(torch, mx, seed):
    """(a): BERT-base exported, imported, predicted, hybridized and trained
    in lockstep with the Gluon net. Returns the numbers and the files."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import kernels
    a = SYMBOL
    card = a['dev'] == 'cuda'
    ctx = _ctxd(mx, a['dev'])
    dev = ctx.to_torch()
    mx.random.seed(seed)
    net = bert.get_bert_model('bert_12_768_12', max_length=a['seq'],
                              dropout=0.0, use_classifier=False,
                              vocab_size=a['vocab'], **a['bert_kw'])
    net.initialize(ctx=ctx)
    ids, tt, labels = bert_batch(mx, seed, a['batch'], a['seq'], a['vocab'])
    eager = net(ids, tt)            # deferred initialization; the reference
    net.hybridize(static_alloc=True)
    net(ids, tt)                    # the capture
    gluon_ms = _predict_ms(torch, dev, lambda: net(ids, tt))
    t0 = time.perf_counter()
    sym_file, param_file = net.export(str(SYMBOL_DIR / 'bert'))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imp = SymbolBlock.imports(sym_file, ['data0', 'data1'], param_file,
                              ctx=ctx)
    import_s = time.perf_counter() - t0
    ops = {}
    for n in imp._sym._topo():
        ops[n.op] = ops.get(n.op, 0) + 1
    want_fwd = dict(BERT_FORWARD) if card else {}
    before = kernels.launch_counts()
    out = imp(ids, tt)
    _sync_all(torch, a['dev'])
    got = _counts_since(kernels, before)
    if got != want_fwd:
        fail(f'symbol: (a) an imported predict launched {got}, want '
             f'{want_fwd}')
    bit = _equal_outs(torch, '(a) imported predict against the Gluon net',
                      out, eager, 1e-6)
    imp.hybridize(static_alloc=True)
    graphed = []
    for i in range(3):
        before = kernels.launch_counts()
        res = imp(ids, tt)
        _sync_all(torch, a['dev'])
        graphed.append(_counts_since(kernels, before))
        _equal_outs(torch, f'(a) hybridized imported predict {i + 1}', res,
                    eager, 1e-6)
    want_caps = 1 if card else 0
    if graphed != [want_fwd] * 3 or imp.capture_count != want_caps or \
            imp.compile_count != 1:
        fail(f'symbol: (a) the hybridized imported block launched '
             f'{graphed}, captured {imp.capture_count} and keyed '
             f'{imp.compile_count} (want {want_fwd} a call, {want_caps}, 1)')
    imp_ms = _predict_ms(torch, dev, lambda: imp(ids, tt))
    log(f'[symbol] (a) bert_12_768_12 ({a["batch"]}, {a["seq"]}) exported in '
        f'{export_s:.1f} s ({os.path.getsize(sym_file) / 1e3:.1f} kB of '
        f'symbol, {os.path.getsize(param_file) / 1e6:.1f} MB of parameters) '
        f'and imported in {import_s:.1f} s: {len(imp.collect_params())} '
        f'parameters; graph ops {dict(sorted(ops.items()))}; a predict '
        f'launches {want_fwd}; outputs '
        f'{"bit-equal to" if bit else "within 1e-6 of"} the Gluon net\'s; '
        f'hybridized: {imp.capture_count} capture over 3 calls; host ms a '
        f'graphed predict: imported {[round(x, 3) for x in imp_ms]}, Gluon '
        f'{[round(x, 3) for x in gluon_ms]}; card '
        f'{smi_line() if card else "host (a rehearsal)"}')

    # three Adam steps in lockstep from the exported weights
    params = net.collect_params()
    start = mx.model.load_ndarray_map(param_file, ctx=ctx)
    for k, p in params.items():
        p.set_data(start[k])
    trained = SymbolBlock.imports(sym_file, ['data0', 'data1'], param_file,
                                  ctx=ctx)
    trained(ids, tt)
    trained.hybridize(static_alloc=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    hyper = dict(BERT_OPTS[0][2])
    runs = {}
    init = {k: v._data.detach().clone() for k, v in start.items()}
    # the Gluon net twice: on the card an embedding's backward adds its
    # rows with atomics, so two runs of one net part in the last bits,
    # which Adam's division carries into the weights
    for tag, blk in (('gluon', net), ('imported', trained),
                     ('gluon again', net)):
        if tag == 'gluon again':
            for k, p in params.items():
                p.set_data(start[k])
        tr = gluon.Trainer(blk.collect_params(), 'adam', dict(hyper))
        losses, counts = [], []
        for _ in range(BERT_STEPS):
            before = kernels.launch_counts()
            loss = bert_step(mx, blk, tr, loss_fn, ids, tt, labels)
            losses.append(loss.item())
            counts.append(_counts_since(kernels, before))
        runs[tag] = (losses, counts, {
            k: p.data()._data.detach().clone()
            for k, p in blk.collect_params().items()})
    want_step = dict(BERT_FORWARD, adam=BERT_UPDATED) if card else {}
    (gl, gc, gw), (il, ic, iw) = runs['gluon'], runs['imported']
    if ic != [want_step] * BERT_STEPS or gc != ic:
        fail(f'symbol: (a) a training step launched {ic} (the Gluon net '
             f'{gc}), want {want_step}')
    if sorted(gw) != sorted(iw):
        fail('symbol: (a) the imported block has other parameters than the '
             'Gluon net')
    bit_w = all(torch.equal(gw[k], iw[k]) for k in gw) and gl == il
    bad, worst = _change_gaps(init, {False: (gl, gw), True: (il, iw)})
    _, control = _change_gaps(init, {False: (gl, gw),
                                     True: runs['gluon again'][::2]})
    same_loss = all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(il, gl))
    log(f'[symbol] (a) {BERT_STEPS} Adam steps in lockstep: losses Gluon '
        f'{gl}, imported {il}, Gluon again {runs["gluon again"][0]}; '
        f'{"bit-equal" if bit_w else "not bit-equal"}; |imported change - '
        f'Gluon change| over |Gluon change|, worst {worst} (1e-2; the Gluon '
        f'net against itself: {control}); a step launches {ic[-1]}; '
        f'captures imported {trained.capture_count}')
    if not bit_w and (bad or not same_loss):
        fail(f'symbol: (a) the imported block trained apart from the Gluon '
             f'net: losses {il} against {gl} (rtol 1e-4); past 1e-2 {bad}')
    moved = sum(not torch.equal(iw[k], init[k]) for k in iw)
    if not il[-1] < il[0] or not moved:
        fail(f'symbol: (a) the imported block did not train: {il}')
    del runs, gw, iw, start, init
    return dict(imp_ms=imp_ms, gluon_ms=gluon_ms, sym_file=sym_file,
                param_file=param_file, ids=ids, tt=tt, bit=bit,
                bit_train=bit_w)


def _symbol_bf16(torch, mx, got):
    """(b): ``amp.convert_model`` of (a)'s symbol, run on the card and held
    to the same converted symbol on the host."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.amp import lists
    from mxnet_tpu_torch.gluon import SymbolBlock
    card = SYMBOL['dev'] == 'cuda'
    ctx = _ctxd(mx, SYMBOL['dev'])
    dev = ctx.to_torch()
    sym = mx.sym.load(got['sym_file'])
    args = mx.model.load_ndarray_map(got['param_file'], ctx=ctx)
    host_args = {k: v.as_in_context(mx.cpu()) for k, v in args.items()}
    ids, tt = got['ids'], got['tt']
    rows = slice(0, SYMBOL_BF16_ROWS)
    h_ids, h_tt = (x[rows].as_in_context(mx.cpu()) for x in (ids, tt))
    # the fp32 symbol on the host: how far bf16 is from it on each side
    h32 = _outs(SymbolBlock(sym, ['data0', 'data1'], params=host_args)(
        h_ids, h_tt))
    res = {}
    # the reference's lists (layer_norm in fp32), then layer_norm moved to
    # the target list, so that B1 takes its bf16 entry too
    for tag, kw in (('lists', {}), ('norm_bf16', dict(
            target_dtype_ops=lists.TARGET_DTYPE_OPS | {'layer_norm'},
            fp32_ops=lists.FP32_OPS - {'layer_norm'}))):
        csym, cargs, _ = amp.convert_model(sym, args, **kw)
        casts = sum(n.op == 'amp_cast' for n in csym._topo())
        blk = SymbolBlock(csym, ['data0', 'data1'], params=cargs)
        blk(ids, tt)
        eager_ms = _predict_ms(torch, dev, lambda: blk(ids, tt))
        blk.hybridize(static_alloc=True)
        blk(ids, tt)                    # the capture
        ms = _predict_ms(torch, dev, lambda: blk(ids, tt))
        # a replayed predict, profiled: each launch's element type. In a
        # full run the first port-kernel events of this session went
        # missing (ROADMAP C5; never with the phase alone): a short run of
        # small kernels opens it, and it is taken again up to twice as often
        pad = torch.zeros(1, device=dev)

        def call():
            for _ in range(0 if C5_PROBE else 64):
                pad.add_(1.0)
            res = blk(ids, tt)
            torch.cuda.synchronize()
            return res

        if card and C5_PROBE:
            # the probe: one session with no small kernels before it
            *_, short = profile_once(
                torch, f'symbol bf16 {tag} graphed predict, C5 probe', call)
            log(f'[c5] symbol bf16 {tag}: the first session with no '
                f'warm-up kernels lost {short or "no events"}')
        if card:
            prof, out, _, launched = profile_checked(
                torch, f'symbol bf16 {tag} graphed predict', call,
                tries=2 * PROFILE_TRIES)
            dtypes = _dtype_events(prof, ('fused_norm', 'flash_fwd'))
        else:
            out, launched, dtypes = blk(ids, tt), {}, {}
        want_norm = 'bf16' if tag == 'norm_bf16' else 'fp32'
        if card and (dtypes['flash_fwd'] != {'bf16': BERT_FORWARD[
                'flash_attention']} or dtypes['fused_norm'] != {
                want_norm: BERT_FORWARD['fused_norm']}):
            fail(f'symbol: (b) {tag}: the kernels ran in {dtypes}; want B2 '
                 f'in bf16 and B1 in {want_norm}')
        # the same converted symbol on the host, on the first rows
        hblk = SymbolBlock(csym, ['data0', 'data1'],
                           params=amp.convert_model(sym, host_args, **kw)[1])
        want = _outs(hblk(h_ids, h_tt))

        def gap(a, b):
            a, b = a.double().cpu(), b.double().cpu()
            return float((a - b).abs().max() / b.abs().max())

        dev_out = [g._data[rows] for g in _outs(out)]
        e_card = [gap(g, f._data) for g, f in zip(dev_out, h32)]
        e_host = [gap(w._data, f._data) for w, f in zip(want, h32)]
        gaps = [gap(g, w._data) for g, w in zip(dev_out, want)]
        # each side's bf16 rounds in its own places: the card's output is
        # held to be as near the fp32 output as the host's bf16 one is
        ok = all(math.isfinite(c) and c <= 2 * h + 1e-3
                 for c, h in zip(e_card, e_host))

        def r3(xs):
            return [float(f'{x:.3g}') for x in xs]

        res[tag] = ms
        log(f'[symbol] (b) amp.convert_model ({tag}): {casts} amp_cast '
            f'nodes; a graphed predict launches {launched}, element types '
            f'{dtypes}; on {SYMBOL_BF16_ROWS} sequences, largest gap over '
            f'the largest |value|: card bf16 against host bf16 {r3(gaps)}, '
            f'against host fp32 {r3(e_card)} (limit 2x the host bf16\'s '
            f'{r3(e_host)} + 1e-3) -> {"ok" if ok else "MISMATCH"}; host '
            f'ms a predict: eager {[round(x, 3) for x in eager_ms]}, '
            f'graphed {[round(x, 3) for x in ms]} against (a)\'s graphed '
            f'fp32 imported {[round(x, 3) for x in got["imp_ms"]]}')
        if not ok:
            fail(f'symbol: (b) {tag}: the card\'s bf16 outputs are farther '
                 f'from fp32 ({e_card}) than twice the host\'s ({e_host})')
        del blk, hblk, out, want, dev_out
    return res


def _symbol_files(torch, mx, seed):
    """(c): the JAX package's committed mobilenet files on the card, and
    ResNet-50 exported and imported."""
    import numpy as np
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import kernels
    card = SYMBOL['dev'] == 'cuda'
    ctx = _ctxd(mx, SYMBOL['dev'])
    fixdir = ROOT / 'tests' / 'fixtures' / 'format'
    fixed = SymbolBlock.imports(str(fixdir / 'mobilenet0_25-symbol.json'),
                                'data', str(fixdir /
                                            'mobilenet0_25-0000.params.npz'),
                                ctx=ctx)
    x = mx.np.array(np.load(fixdir / 'mobilenet0_25.input.npy'), ctx=ctx)
    want = torch.from_numpy(np.load(fixdir / 'mobilenet0_25.output.npy'))
    err, ok = compare(torch, fixed(x)._data.cpu(), want, 1e-4, 1e-20)
    log(f'[symbol] (c) the JAX package\'s mobilenet0_25 files on '
        f'{x.context}: max |diff| against its recorded output {err:.3g} '
        f'(rtol 1e-4) -> {"ok" if ok else "MISMATCH"}')
    if not ok:
        fail('symbol: (c) the committed mobilenet files part from their '
             'recorded output')
    mx.random.seed(seed)
    net = vision.get_model(SYMBOL['resnet'])
    net.initialize(ctx=ctx)
    rng = np.random.default_rng(seed)
    x = mx.np.array(rng.standard_normal(
        (SYMBOL['images'], 3, SYMBOL['side'], SYMBOL['side'])).astype('f'),
        ctx=ctx)
    net(x)
    net.hybridize(static_alloc=True)
    ref = net(x)
    t0 = time.perf_counter()
    files = net.export(str(SYMBOL_DIR / 'resnet'))
    imp = SymbolBlock.imports(*files[:1], 'data', files[1], ctx=ctx)
    dt = time.perf_counter() - t0
    imp(x)
    imp.hybridize(static_alloc=True)
    outs = []
    for _ in range(3):
        before = kernels.launch_counts()
        outs.append(imp(x))
        if _counts_since(kernels, before):
            fail(f'symbol: (c) an imported resnet predict launched '
                 f'{_counts_since(kernels, before)}, want no kernel')
    bit = all(_equal_outs(torch, f'(c) {SYMBOL["resnet"]} imported graphed '
                          f'predict', o, ref, 1e-6) for o in outs)
    if imp.capture_count != (1 if card else 0):
        fail(f'symbol: (c) the imported resnet captured '
             f'{imp.capture_count} graphs')
    log(f'[symbol] (c) {SYMBOL["resnet"]} at {tuple(x.shape)} exported and '
        f'imported in {dt:.1f} s; graphed imported predict '
        f'{"bit-equal to" if bit else "within 1e-6 of"} the Gluon net\'s '
        f'graphed predict, {imp.capture_count} capture over 3 calls')


#: (d): the ndarray phase's step under engine.bulk(n) for these n, and
#: chains of these many elementwise ops on a (4, 4096) array
SYMBOL_BULK = (8, 4096)
SYMBOL_CHAINS = (8, 64)


def _bulk_step_run(torch, mx, p0, tokens, w, n):
    """``NDARRAY_STEPS`` Adam steps of :func:`frontend_loss` from the
    weights ``p0``: eagerly (``n`` None) or with the recorded forward and
    its backward under ``engine.bulk(n)`` (the update eager, outside the
    scope). Returns (losses, weights, launches a step, host ms a step,
    segment shapes captured a step)."""
    from mxnet_tpu_torch import _bulk, engine
    from mxnet_tpu_torch.ops import kernels
    dev = tokens.context.to_torch()
    hyper = dict(FRONTEND_OPTS[0][1])
    p = {k: mx.NDArray(v.clone()) for k, v in p0.items()}
    for a in p.values():
        a.attach_grad()
    slots = frontend_slots(mx, p, 'adam')
    _bulk.reset()
    losses, counts, ms, caps = [], [], [], []
    for t in range(1, NDARRAY_STEPS + 1):
        before = kernels.launch_counts()
        c0 = _bulk.stats()['compiles']
        _sync_all(torch, dev.type)
        t1 = time.perf_counter()
        with (engine.bulk(n) if n else contextlib.nullcontext()):
            loss = frontend_backward(mx, p, tokens, w)
        frontend_update(mx, p, slots, 'adam', hyper, t)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t1) * 1e3)
        counts.append(_counts_since(kernels, before))
        caps.append(_bulk.stats()['compiles'] - c0)
        del loss
    weights = {k: v._data.detach() for k, v in p.items()}
    del p, slots
    _bulk.reset()           # the captured segments go with their pools
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    return losses, weights, counts, ms, caps


def _bulk_chain_us(torch, mx, n_ops, rounds=5, reps=20):
    """Host us an op of a chain of ``n_ops`` elementwise ops (alternately
    ``* 0.5`` and ``+ 1.0``) on a (4, 4096) array, eager and under
    ``engine.bulk(n_ops)`` (one segment a chain, replayed after its
    first), the least of ``rounds`` rounds of ``reps`` chains, each chain
    ending in a read of its result's payload and a sync."""
    from mxnet_tpu_torch import _bulk, engine
    x0 = mx.np.ones((4, 4096))
    dev = x0.context.to_torch()

    def chain():
        x = x0
        for i in range(n_ops):
            x = x * 0.5 if i % 2 == 0 else x + 1.0
        return x._data

    def per_op(bulked):
        best = math.inf
        for _ in range(rounds + 1):       # the first round warms up
            _sync_all(torch, dev.type)
            t0 = time.perf_counter()
            for _ in range(reps):
                with (engine.bulk(n_ops) if bulked
                      else contextlib.nullcontext()):
                    out = chain()
            _sync_all(torch, dev.type)
            best = min(best, (time.perf_counter() - t0) / reps / n_ops
                       * 1e6)
        return best, out

    _bulk.reset()
    eager_us, want = per_op(False)
    c0 = _bulk.stats()['compiles']
    bulk_us, got = per_op(True)
    if not torch.equal(got, want):
        fail('symbol: (d) the bulked chain parts from the eager one')
    return eager_us, bulk_us, _bulk.stats()['compiles'] - c0


def _symbol_bulk(torch, mx, seed):
    """(d): the bulking engine against eager dispatch."""
    card = SYMBOL['dev'] == 'cuda'
    w = FRONTEND_WIDTHS['llama3_8b'] if card else FRONTEND_WIDTHS['llama_tiny']
    mx.random.seed(seed)
    p0 = {n: (mx.np.ones(shape) if len(shape) == 1 else
              mx.np.random.normal(0.0, 0.02, size=shape))._data
          for n, shape in frontend_shapes(w).items()}
    tokens = mx.np.random.randint(0, w['vocab'],
                                  size=(1, NDARRAY_TOKENS + 1))
    el, ew, ec, ems, _ = _bulk_step_run(torch, mx, p0, tokens, w, None)
    smi = smi_line() if card else 'host (a rehearsal)'
    log(f'[symbol] (d) eager: losses {el}, launches a step {ec[-1]}, host '
        f'ms a step {[round(x, 2) for x in ems]} ({smi})')
    steps = {None: ems}
    for n in SYMBOL_BULK:
        bl, bw, bc, bms, caps = _bulk_step_run(torch, mx, p0, tokens, w, n)
        if bc != ec:
            fail(f'symbol: (d) bulk({n}) launched {bc}, eagerly {ec}')
        if caps[1:] != [0] * (len(caps) - 1) or not caps[0]:
            fail(f'symbol: (d) bulk({n}) captured {caps} segment shapes a '
                 f'step; want some in the first step and none after it')
        bit = bl == el and all(torch.equal(bw[k], ew[k]) for k in ew)
        bad, worst = _change_gaps(p0, {False: (el, ew), True: (bl, bw)})
        del bw
        steps[n] = bms
        log(f'[symbol] (d) bulk({n}): losses {bl}; '
            f'{"bit-equal to eager" if bit else "not bit-equal"} (worst '
            f'change gap {worst}); launches a step as eager; segment shapes '
            f'captured a step {caps}; host ms a step '
            f'{[round(x, 2) for x in bms]} ({smi})')
        if not bit and (bad or not all(
                math.isclose(a, b, rel_tol=1e-4) for a, b in zip(bl, el))):
            fail(f'symbol: (d) bulk({n}) trained apart from eager: {bl} '
                 f'against {el}; past 1e-2 {bad}')
    del ew, p0
    chains = {}
    for n_ops in SYMBOL_CHAINS:
        eager_us, bulk_us, caps = _bulk_chain_us(torch, mx, n_ops)
        chains[n_ops] = (eager_us, bulk_us)
        log(f'[symbol] (d) a chain of {n_ops} elementwise ops on (4, 4096): '
            f'host us an op eager {eager_us:.2f}, bulked {bulk_us:.2f} '
            f'({caps} capture; {eager_us / bulk_us:.2f}x); {smi}')
    return dict(chains=chains, steps=steps)


def phase_symbol(torch, seed):
    """The symbol phase: see the module docstring."""
    import shutil
    import mxnet_tpu_torch as mx
    shutil.rmtree(SYMBOL_DIR, ignore_errors=True)
    SYMBOL_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    with _ctxd(mx, SYMBOL['dev']):
        got = _symbol_bert(torch, mx, seed)
        t_a = time.perf_counter()
        got['bf16'] = _symbol_bf16(torch, mx, got)
        t_b = time.perf_counter()
        _symbol_files(torch, mx, seed + 1)
        t_c = time.perf_counter()
        gc.collect()            # (a)-(c)'s nets and their graphs' pools
        if SYMBOL['dev'] == 'cuda':
            torch.cuda.empty_cache()
        got['bulk'] = _symbol_bulk(torch, mx, seed + 2)
    t_d = time.perf_counter()
    card = 'host (a rehearsal)' if REHEARSE else smi_line()
    log(f'[symbol] {card}; (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, '
        f'(c) {t_c - t_b:.1f} s, (d) {t_d - t_c:.1f} s')
    shutil.rmtree(SYMBOL_DIR, ignore_errors=True)
    return got


# ----------------------------------------------------------------- gluon
GLUON_DIR = ROOT / 'build' / 'gluon'
#: the gluon phase: (a) an HF-named Llama at llama3_8b's widths and this
#: many layers, bf16 as HF checkpoints ship, over a seeded (1, tokens)
#: batch
GLUON = dict(model='llama3_8b', layers=2, tokens=64, dev='cuda')


def hf_llama_state(torch, cfg, seed, dev):
    """An HF-named Llama state dict (``model.layers.{i}.``, rotate-half q
    and k) at ``cfg``'s widths, in bf16 on the host: projections and
    embeddings N(0, 0.02), norms 1 + N(0, 0.02), drawn on ``dev`` from a
    generator seeded with ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u, f, v = cfg.units, cfg.hidden_size, cfg.vocab_size
    kv = cfg.num_kv_heads * (u // cfg.num_heads)

    def w(*shape, one=False):
        t = torch.empty(shape, device=dev).normal_(0.0, 0.02, generator=g)
        return (t + 1.0 if one else t).to(torch.bfloat16).cpu()
    sd = {'model.embed_tokens.weight': w(v, u)}
    for i in range(cfg.num_layers):
        p = f'model.layers.{i}.'
        sd.update({p + 'input_layernorm.weight': w(u, one=True),
                   p + 'self_attn.q_proj.weight': w(u, u),
                   p + 'self_attn.k_proj.weight': w(kv, u),
                   p + 'self_attn.v_proj.weight': w(kv, u),
                   p + 'self_attn.o_proj.weight': w(u, u),
                   p + 'post_attention_layernorm.weight': w(u, one=True),
                   p + 'mlp.gate_proj.weight': w(f, u),
                   p + 'mlp.up_proj.weight': w(f, u),
                   p + 'mlp.down_proj.weight': w(u, f)})
    sd['model.norm.weight'] = w(u, one=True)
    sd['lm_head.weight'] = w(v, u)
    return sd


def hf_config(cfg):
    """``config.json`` of a HuggingFace Llama with ``cfg``'s fields."""
    return {'architectures': ['LlamaForCausalLM'], 'model_type': 'llama',
            'vocab_size': cfg.vocab_size, 'hidden_size': cfg.units,
            'intermediate_size': cfg.hidden_size,
            'num_hidden_layers': cfg.num_layers,
            'num_attention_heads': cfg.num_heads,
            'num_key_value_heads': cfg.num_kv_heads,
            'max_position_embeddings': cfg.max_length,
            'rope_theta': cfg.rope_theta, 'rms_norm_eps': cfg.rms_norm_eps,
            'tie_word_embeddings': False, 'torch_dtype': 'bfloat16'}


def rotate_half_logits(torch, sd, cfg, toks):
    """The logits of ``toks`` from HF-named weights ``sd`` by a plain
    PyTorch Llama written as HuggingFace's is (rotate-half RoPE on q and k
    as the checkpoint stores them, GQA, SwiGLU, RMSNorm), fp32 on the
    tokens' device: the reference the HF import is held to."""
    dev = toks.device
    H, KV = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.units // H
    B, S = toks.shape

    def w(name):
        return sd[name].to(dev, torch.float32)

    def rms(x, g):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + cfg.rms_norm_eps) * g

    def rot_half(t):
        return torch.cat([-t[..., dh // 2:], t[..., :dh // 2]], dim=-1)
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, dh, 2, device=dev,
                                                 dtype=torch.float32) / dh))
    ang = torch.arange(S, device=dev, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = torch.full((S, S), float('-inf'), device=dev).triu(1)
    x = w('model.embed_tokens.weight')[toks]
    for i in range(cfg.num_layers):
        p = f'model.layers.{i}.'
        h = rms(x, w(p + 'input_layernorm.weight'))
        q = (h @ w(p + 'self_attn.q_proj.weight').T).view(
            B, S, H, dh).transpose(1, 2)
        k = (h @ w(p + 'self_attn.k_proj.weight').T).view(
            B, S, KV, dh).transpose(1, 2)
        v = (h @ w(p + 'self_attn.v_proj.weight').T).view(
            B, S, KV, dh).transpose(1, 2)
        q = q * cos + rot_half(q) * sin
        k = k * cos + rot_half(k) * sin
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        att = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5 + mask, -1)
        o = (att @ v).transpose(1, 2).reshape(B, S, H * dh)
        x = x + o @ w(p + 'self_attn.o_proj.weight').T
        h = rms(x, w(p + 'post_attention_layernorm.weight'))
        gate = torch.nn.functional.silu(h @ w(p + 'mlp.gate_proj.weight').T)
        x = x + (gate * (h @ w(p + 'mlp.up_proj.weight').T)) @ \
            w(p + 'mlp.down_proj.weight').T
    x = rms(x, w('model.norm.weight'))
    return x @ w('lm_head.weight').T


def _gluon_hf(torch, mx, seed):
    """(a) The HF import on the card: an HF-named state dict at
    ``llama3_8b``'s widths and ``GLUON['layers']`` layers written as
    ``pytorch_model.bin`` and as ``model.safetensors``, each beside a
    ``config.json``, and loaded by ``from_hf_pretrained``: the logits
    bit-equal between the two files and to the same weights set through
    ``collect_params()``, within 1e-3 of the largest logit of
    :func:`rotate_half_logits`, and 2L + 1 B1 and L B2 a forward."""
    from mxnet_tpu_torch.gluon.model_zoo import llama
    from mxnet_tpu_torch.ops import kernels
    full_fp32(torch)
    cfg = llama.get_llama(GLUON['model'], num_layers=GLUON['layers']).cfg
    dev = torch.device(GLUON['dev'], 0) if GLUON['dev'] == 'cuda' \
        else torch.device('cpu')
    t0 = time.perf_counter()
    sd = hf_llama_state(torch, cfg, seed, dev)
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    files = {}
    for fmt in ('bin', 'safetensors'):
        d = GLUON_DIR / fmt
        d.mkdir(parents=True)
        (d / 'config.json').write_text(json.dumps(hf_config(cfg)))
        if fmt == 'bin':
            torch.save(sd, d / 'pytorch_model.bin')
        else:
            write_safetensors(d / 'model.safetensors', sd)
        files[fmt] = d
    t_write = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (1, GLUON['tokens']),
                         generator=torch.Generator().manual_seed(seed + 1))
    toks = toks.to(dev)
    want = dict.fromkeys(KERNELS, 0)
    want.update(fused_norm=2 * cfg.num_layers + 1,
                flash_attention=cfg.num_layers)
    logits, load_s = {}, {}
    for fmt, d in files.items():
        t1 = time.perf_counter()
        net = llama.from_hf_pretrained(str(d))
        _sync(torch, dev)
        load_s[fmt] = time.perf_counter() - t1
        if _device(net) != dev:
            fail(f'gluon: (a) from_hf_pretrained put the net on '
                 f'{_device(net)}, want {dev}')
        before = kernels.launch_counts()
        logits[fmt] = _t(net(toks)).float()
        got = {k: v for k, v in _counts_since(kernels, before).items()}
        got = {k: got.get(k, 0) for k in want}
        if dev.type == 'cuda' and got != want:
            fail(f'gluon: (a) the {fmt} net\'s forward launched {got}, '
                 f'want {want}')
        del net
    # the same weights set through collect_params() by their own names
    net = llama.get_llama(GLUON['model'], num_layers=GLUON['layers'])
    net.collect_params().setattr('grad_req', 'null')
    net.initialize(mx.init.Zero(), ctx=mx.gpu(0) if dev.type == 'cuda'
                   else mx.cpu())
    own = net.collect_params()
    for name, v in sd.items():
        own[llama._hf_name(name)].set_data(
            llama._hf_to_interleaved(v, cfg.num_heads, cfg.units //
                                     cfg.num_heads)
            if name.endswith('q_proj.weight') else
            llama._hf_to_interleaved(v, cfg.num_kv_heads, cfg.units //
                                     cfg.num_heads)
            if name.endswith('k_proj.weight') else v)
    logits['params'] = _t(net(toks)).float()
    del net
    ref = rotate_half_logits(torch, sd, cfg, toks)
    scale = float(ref.abs().max())
    gap = float((logits['bin'] - ref).abs().max()) / scale
    same = torch.equal(logits['bin'], logits['safetensors']) and \
        torch.equal(logits['bin'], logits['params'])
    log(f'[gluon] (a) HF import: {cfg.num_layers} layers at '
        f'{GLUON["model"]}\'s widths, {nbytes / 1e9:.2f} GB of bf16 '
        f'weights written as pytorch_model.bin and model.safetensors in '
        f'{t_write:.1f} s; from_hf_pretrained {load_s["bin"]:.1f} s (bin), '
        f'{load_s["safetensors"]:.1f} s (safetensors); logits of a (1, '
        f'{GLUON["tokens"]}) forward {"bit-equal" if same else "DIFFER"} '
        f'between the files and collect_params(); against the rotate-half '
        f'reference {gap:.3g} of its largest logit {scale:.3f} (limit '
        f'1e-3); launches a forward {want}')
    if not same or not gap <= 1e-3:
        fail(f'gluon: (a) the HF import: bit-equal {same}, gap {gap:.3g}')
    return dict(write_s=t_write, load_s=load_s, gap=gap, gb=nbytes / 1e9)


def _gluon_create_graph(torch, mx, seed):
    """(b) A gradient penalty ``||dL/dx||^2`` through a hybridized block
    whose recorded calls replay on the card: ``create_graph=True`` through
    the replayed node (its forward run again eagerly under autograd) gives
    ``hybridize(False)``'s input and parameter gradients at 1e-5."""
    from mxnet_tpu_torch.gluon import nn
    ctx = _ctxd(mx, GLUON['dev'])
    dev = ctx.to_torch()
    g = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn(64, 1024, device=dev, generator=g)
    init = None
    grads, ms = {}, {}
    for graphed in (True, False):
        net = nn.HybridSequential(nn.Dense(1024, in_units=1024),
                                  nn.GELU(), nn.Dense(256, in_units=1024))
        net.initialize(mx.init.Normal(0.02), ctx=ctx)
        if init is None:
            init = {k: p.data()._data.clone()
                    for k, p in net.collect_params().items()}
        for k, p in net.collect_params().items():
            p.set_data(init[k])
        x = mx.NDArray(x0.clone())
        net(x)
        if graphed:
            net.hybridize()
        x.attach_grad()
        for _ in range(2):          # a capture, then a replay
            _sync(torch, dev)
            t0 = time.perf_counter()
            with mx.autograd.record():
                loss = (net(x) ** 2).mean()
                gx = mx.autograd.grad(loss, [x], create_graph=True)[0]
                penalty = (gx ** 2).sum()
            penalty.backward()
            _sync(torch, dev)
            ms[graphed] = (time.perf_counter() - t0) * 1e3
        grads[graphed] = [x.grad._data.clone()] + [
            p.grad()._data.clone() for p in net.collect_params().values()]
        caps = net.capture_count
    errs = [compare(torch, a, b, 1e-5, 1e-5)
            for a, b in zip(grads[True], grads[False])]
    ok = all(k for _, k in errs)
    log(f'[gluon] (b) create_graph=True through a replayed call (Dense 1024 '
        f'-> GELU -> Dense 256, (64, 1024) input): the penalty\'s input and '
        f'{len(errs) - 1} parameter gradients against hybridize(False)\'s, '
        f'max |diff| {max(e for e, _ in errs):.3g} (rtol 1e-5) -> '
        f'{"ok" if ok else "MISMATCH"}; host ms a step graphed '
        f'{ms[True]:.2f}, eager {ms[False]:.2f}')
    if not ok:
        fail('gluon: (b) create_graph through a replay parts from eager')
    return dict(ms=ms)


def _gluon_remat_dropout(torch, mx, seed):
    """(c) ``bert_12_768_12``'s 12 encoder cells with dropout 0.1 at the bert
    phase's (32, 128) batch, hybridized with and without ``remat=True``:
    the generator reseeded between the capture and the replay, the
    replayed call's gradients from the same generator state equal (the
    remat backward graph draws with the forward's seed and offset), and
    the peak memory of each."""
    from mxnet_tpu_torch.gluon.model_zoo import bert
    ctx = _ctxd(mx, GLUON['dev'])
    dev = ctx.to_torch()
    cuda = dev.type == 'cuda'
    g = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn(BERT_BATCH, BERT_SEQ, 768, device=dev, generator=g)
    init = None
    grads, peak, ms = {}, {}, {}
    for remat in (False, True):
        net = bert.BERTEncoder(12, 768, 3072, 12, dropout=0.1)
        net.initialize(mx.init.Normal(0.02), ctx=ctx)
        x = mx.NDArray(x0)
        net(x)
        if init is None:
            init = {k: p.data()._data.clone()
                    for k, p in net.collect_params().items()}
        for k, p in net.collect_params().items():
            p.set_data(init[k])
        net.hybridize(remat=remat)
        mem = _memory_start(torch, dev) if cuda else None
        mx.random.seed(seed + 1000)
        with mx.autograd.record():      # the capture
            loss = (net(x) ** 2).mean()
        loss.backward()
        mx.random.seed(seed)            # another seed than the capture's
        t0 = time.perf_counter()
        with mx.autograd.record():      # a replay
            loss = (net(x) ** 2).mean()
        loss.backward()
        _sync(torch, dev)
        ms[remat] = (time.perf_counter() - t0) * 1e3
        peak[remat] = _memory_peaks(torch, dev, mem) if cuda else (0.0, 0.0)
        grads[remat] = {k: p.grad()._data.clone()
                        for k, p in net.collect_params().items()}
        if cuda and (net.capture_count != 2 or net.eager_call_count):
            fail(f'gluon: (c) remat={remat}: {net.capture_count} captures, '
                 f'{net.eager_call_count} eager calls, want 2 and 0')
        del net
        _empty_cache(torch)
    errs = [compare(torch, grads[True][k], v, 1e-5, 1e-6)
            for k, v in grads[False].items()]
    ok = all(k for _, k in errs)
    log(f'[gluon] (c) BERT-base\'s 12 cells, dropout 0.1, (32, 128): the '
        f'replayed call\'s {len(errs)} gradients with remat against '
        f'without, from the same generator state, max |diff| '
        f'{max(e for e, _ in errs):.3g} (rtol 1e-5) -> '
        f'{"ok" if ok else "MISMATCH"}; peak GiB over the capture and the '
        f'replay (allocated, reserved: a graph\'s activations live in its '
        f'pool) {tuple(round(v, 3) for v in peak[False])} without remat, '
        f'{tuple(round(v, 3) for v in peak[True])} with; '
        f'host ms a step {ms[False]:.2f} and {ms[True]:.2f}')
    if not ok:
        fail('gluon: (c) the remat backward drew other dropout masks')
    return dict(peak=peak, ms=ms)


def _gluon_deformable(torch, mx, seed):
    """(d) ``gluon.contrib.cnn.DeformableConvolution`` (over the registered
    ``deformable_convolution`` op) at (4, 32, 28, 28), 3 x 3, 32 filters,
    its offsets about 0.5 of a pixel (the offset layer's bias 0.5, its
    weights N(0, 0.002)): the output and the input,
    weight, bias and offset-layer gradients of ``sum(out ** 2)`` on the
    card against the same net on the CPU, at 1e-5."""
    from mxnet_tpu_torch.gluon.contrib.cnn import DeformableConvolution
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4, 32, 28, 28, generator=g)
    res, nets = {}, {}
    for where in ('cpu', GLUON['dev']):
        ctx = _ctxd(mx, where)
        with ctx:
            net = DeformableConvolution(32, kernel_size=3, padding=1,
                                        in_channels=32)
            net.initialize(mx.init.Normal(0.05))
            net(mx.NDArray(x.to(ctx.to_torch())))
            # offsets near 0.5 of a pixel, away from the integers where a
            # sample's corners (and the offsets' gradient) change
            off = net.offset_conv
            off.bias.set_data(torch.full(off.bias.shape, 0.5))
            off.weight.set_data(off.weight.data()._data * 0.04)
        if nets:
            for k, p in net.collect_params().items():
                p.set_data(nets['cpu'].collect_params()[k].data()._data)
        nets[where] = net
        xx = mx.NDArray(x.to(ctx.to_torch()))
        xx.attach_grad()
        t0 = time.perf_counter()
        with mx.autograd.record():
            out = net(xx)
            loss = (out ** 2).sum()
        loss.backward()
        _sync(torch, ctx.to_torch())
        ms = (time.perf_counter() - t0) * 1e3
        ps = net.collect_params()
        res[where] = ([out._data, xx.grad._data] + [
            ps[k].grad()._data for k in ('weight', 'bias',
                                         'offset_conv.weight')], ms)
    # 1e-5 of each tensor's largest value: a gradient sums 3136 terms a
    # weight in another order on each device
    errs = [compare(torch, a.cpu(), b, 1e-5, 1e-5 * float(b.abs().max()))
            for a, b in zip(res[GLUON['dev']][0], res['cpu'][0])]
    ok = all(k for _, k in errs)
    log(f'[gluon] (d) DeformableConvolution (4, 32, 28, 28), 3 x 3, 32 '
        f'filters: output and 4 gradients on {GLUON["dev"]} against the '
        f'CPU, max |diff| {max(e for e, _ in errs):.3g} (1e-5 of each '
        f'tensor\'s largest value) -> '
        f'{"ok" if ok else "MISMATCH"}; a forward and backward '
        f'{res[GLUON["dev"]][1]:.2f} host ms there, '
        f'{res["cpu"][1]:.2f} on the CPU')
    if not ok:
        fail('gluon: (d) DeformableConvolution parts from the CPU')
    return dict(ms=res[GLUON['dev']][1])


def phase_gluon(torch, seed):
    """The gluon phase: see the module docstring."""
    import shutil
    import mxnet_tpu_torch as mx
    shutil.rmtree(GLUON_DIR, ignore_errors=True)
    GLUON_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    with _ctxd(mx, GLUON['dev']):
        got = {'a': _gluon_hf(torch, mx, seed)}
        t_a = time.perf_counter()
        shutil.rmtree(GLUON_DIR, ignore_errors=True)
        _empty_cache(torch)
        got['b'] = _gluon_create_graph(torch, mx, seed + 1)
        t_b = time.perf_counter()
        got['c'] = _gluon_remat_dropout(torch, mx, seed + 2)
        t_c = time.perf_counter()
        _empty_cache(torch)
        got['d'] = _gluon_deformable(torch, mx, seed + 3)
        t_d = time.perf_counter()
    log(f'[gluon] {smi_line() if GLUON["dev"] == "cuda" else "host"}; '
        f'(a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, (c) {t_c - t_b:.1f} '
        f's, (d) {t_d - t_c:.1f} s')
    return got


NEW_DESIGNS = {'fused_norm': ('regs', 'cluster'),
               'int8_matmul': ('tma_splitk', 'tma'),
               'flash_attention': ('tf32x3', 'tf32x3_splitkv'),
               'flash_attention_stats': ('tf32x3', 'tf32x3_splitkv'),
               'paged_attention_decode': tuple(
                   f'splits{n}' for n in range(1, 9))}


def check_designs(path, counts, by_design):
    """Fail unless every launch of a planned kernel on the main path
    ``path`` ran one of the new designs."""
    for name, designs in by_design.items():
        new = sum(designs.get(d, 0) for d in NEW_DESIGNS[name])
        if new != counts[name]:
            fail(f'{path}: {name} launched {counts[name]} times, '
                 f'{new} of them in the new designs: {designs}')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--phases', default=','.join(PHASES),
                    help=f'comma-separated subset of {",".join(PHASES)}')
    ap.add_argument('--elastic-worker', choices=('straight', 'crash',
                                                 'resume'),
                    help=argparse.SUPPRESS)   # a process of elastic (a)
    ap.add_argument('--ckpt', help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    ap.add_argument('--host-cost', metavar='DIR',
                    help='time mx.np.add\'s host cost against the package '
                         'of the checkout DIR, in turns (no phases run)')
    ap.add_argument('--llama-host-cost', metavar='DIR',
                    help='time the Llama\'s eager calls against the package '
                         'of the checkout DIR, in turns (no phases run)')
    args = ap.parse_args(argv)
    if args.host_cost:
        sys.path.insert(0, str(ROOT))
        host_cost(args.host_cost)
        return 0
    if args.llama_host_cost:
        sys.path.insert(0, str(ROOT))
        llama_host_cost(args.llama_host_cost)
        return 0
    if args.elastic_worker:
        sys.path.insert(0, str(ROOT))
        return elastic_worker(args.elastic_worker, args.ckpt, args.out)
    phases = args.phases.split(',')
    if not set(phases) <= set(PHASES):
        ap.error(f'unknown phase in {phases}')

    if not (ROOT / 'mxnet_tpu_torch' / '__init__.py').exists():
        fail(f'mxnet_tpu_torch/ is not beside {Path(__file__).name}: run '
             f'this from a checkout of the repository')
    sys.path.insert(0, str(ROOT))
    import torch

    t_start = time.perf_counter()

    def at():
        return f'at {time.perf_counter() - t_start:.1f} s of the run'

    phase_device(torch)         # always: no card, no run
    from mxnet_tpu_torch.ops import kernels

    if 'build' in phases:
        phase_build()
    rows = phase_kernels(torch) if 'kernels' in phases else None
    log(f'[time] device, build and kernels done {at()}')

    paths = {}      # main path -> the launch counts of its run
    serve_ref = None    # the serve phase's tokens, for the sharding phase
    designs = {}    # main path -> {kernel: {design: launches}}

    def window(path, fn, *args):
        kernels.reset_launch_counts()       # the path starts here ...
        out = fn(*args)
        paths[path] = kernels.launch_counts()   # ... and ends here
        designs[path] = kernels.path_counts()
        log(f'[{path}] launches {paths[path]}; by design {designs[path]}; '
            f'{at()}')
        check_designs(path, paths[path], designs[path])
        return out

    if {'forward', 'serve', 'int8'} & set(phases):
        t0 = time.perf_counter()
        net = build_llama('llama3_8b', SEED)
        torch.cuda.synchronize()
        n_par = param_bytes(net) // 4
        log(f'[model] llama3_8b {n_par / 1e9:.2f} B fp32 parameters on '
            f'cuda in {time.perf_counter() - t0:.1f} s, '
            f'{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated')
        logits = outs = None
        if 'forward' in phases:
            logits = window('forward', phase_forward, torch, net, SEED + 1)
        if 'serve' in phases:
            prompts, outs, served = window('serve', phase_serve, torch,
                                           net, SEED + 2)
            # the sharding phase's one-process reference (same weights,
            # prompts and server settings)
            serve_ref = {'outs': [list(o) for o in outs], 'step_ms': None,
                         'tok_s': sum(map(len, outs)) / served['wall_s']}
            teacher_forced(torch, net, prompts[2], outs[2])
            graph_checks(torch, net, prompts[2], outs[2])
            profile_breakdown(torch, net)
        if 'int8' in phases:        # the same net, quantized in place
            got = window('int8', phase_int8, torch, net, SEED + 5, logits,
                         outs)
            del logits
            int8_checks(torch, net, **got)
            int8_parity(torch, SEED + 6)
        log(f'[model] peak memory '
            f'{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB')
        del net
        torch.cuda.empty_cache()
    if 'train' in phases:
        window('train', phase_train, torch, SEED + 3)
        train_parity(torch, SEED + 4)
    if 'ndarray' in phases:
        got = window('ndarray', phase_ndarray, torch, SEED + 9)
        for k in ('fused_norm', 'flash_attention', 'adam', 'sgd_mom',
                  'paged_attention_decode', 'int8_matmul'):
            if not paths['ndarray'][k]:
                fail(f'ndarray: the imperative program never launched {k}')
        ndarray_costs(torch, got)
        del got
        torch.cuda.empty_cache()
    fp32 = {}       # the bert and resnet phases' numbers, for bf16's log
    if 'bert' in phases:
        got = window('bert', phase_bert, torch, SEED + 10)
        bert_costs(torch, got)
        fp32['bert'] = {k: v for k, v in got.items() if k != 'net'}
        del got
        torch.cuda.empty_cache()
        bert_parity(torch, SEED + 11)
    if 'resnet' in phases:
        got = window('resnet', phase_resnet, torch, SEED + 12)
        resnet_costs(torch, got)
        fp32['resnet'] = got
        del got
        torch.cuda.empty_cache()
        resnet_parity(torch, SEED + 13)
    if 'bf16' in phases:
        got = window('bf16', phase_bf16, torch, SEED + 14)
        log(f'[bf16] plain updates in the window (the counters were set to '
            f'0 at its start): {kernels.plain_update_counts()}')
        bf16_costs(torch, got, fp32)
        del got
        torch.cuda.empty_cache()
        bf16_parity(torch, SEED + 15)
    if 'qresnet' in phases:
        got = window('qresnet', phase_qresnet, torch, SEED + 16)
        qresnet_costs(torch, got)
        del got
        torch.cuda.empty_cache()
        b7 = qresnet_rows(torch)
        if rows is not None:
            rows['int8_matmul'].extend(b7)
        qresnet_parity(torch, SEED + 17)
    if 'optim' in phases:
        got = window('optim', phase_optim, torch, SEED + 18)
        optim_costs(torch, got)
        del got
        torch.cuda.empty_cache()
        optim_parity(torch, SEED + 19)
    if 'dist' in phases:        # counted in the ranks, which return counts
        paths['dist'], designs['dist'], got = phase_dist(torch, SEED + 20)
        log(f'[dist] launches {paths["dist"]}; by design {designs["dist"]}; '
            f'{at()}')
        check_designs('dist', paths['dist'], designs['dist'])
        dist_costs(torch, got)
        del got
        torch.cuda.empty_cache()
    if 'dist_async' in phases:  # (a) here, (b) and (c) in the workers
        paths['dist_async'], designs['dist_async'], got = phase_dist_async(
            torch, SEED + 21)
        log(f'[dist_async] launches {paths["dist_async"]}; by design '
            f'{designs["dist_async"]}; {at()}')
        check_designs('dist_async', paths['dist_async'],
                      designs['dist_async'])
        dist_async_costs(torch, got)
        del got
        torch.cuda.empty_cache()
    if 'sharding' in phases:    # counted in the ranks, which return counts
        paths['sharding'], designs['sharding'], got = phase_sharding(
            torch, SEED + 2, serve_ref=serve_ref)
        log(f'[sharding] launches {paths["sharding"]}; by design '
            f'{designs["sharding"]}; {at()}')
        check_designs('sharding', paths['sharding'], designs['sharding'])
        sharding_costs(torch, got)
        del got
        torch.cuda.empty_cache()
    for name, fn, seed in (('elastic', phase_elastic, SEED + 30),
                           ('pipeline', phase_pipeline, SEED + 40),
                           ('moe', phase_moe, SEED + 50)):
        if name in phases:      # counted in the processes, which return
            t0 = time.perf_counter()
            paths[name], designs[name] = fn(torch, seed)
            log(f'[{name}] launches {paths[name]}; by design '
                f'{designs[name]}; {time.perf_counter() - t0:.1f} s, '
                f'{at()}')
            check_designs(name, paths[name], designs[name])
            torch.cuda.empty_cache()
    if 'sparse' in phases:
        window('sparse', phase_sparse, torch, SEED + 60)
        torch.cuda.empty_cache()
        row = sparse_rows(torch, SEED + 61)
        if rows is not None:
            rows['adam'].append(row)
    if 'symbol' in phases:
        window('symbol', phase_symbol, torch, SEED + 70)
        torch.cuda.empty_cache()
    if 'gluon' in phases:
        window('gluon', phase_gluon, torch, SEED + 80)
        torch.cuda.empty_cache()
    if 'ring' in phases:        # counted in the ranks, which return counts
        paths['ring'], designs['ring'] = phase_ring(torch, SEED + 7)
        log(f'[ring] launches {paths["ring"]}; by design {designs["ring"]}; '
            f'{at()}')
        check_designs('ring', paths['ring'], designs['ring'])
    if 'rtc' in phases:
        if rows is None:
            rows = {k: [] for k in KERNELS}
        rtc_checks(torch, rows, **window('rtc', phase_rtc, torch, SEED + 8))

    if PROFILES:
        profile_summary()
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS} \
        if paths else None
    if rows is not None:
        line = []
        for name, meta in KERNELS.items():
            if not rows[name]:
                continue
            # the main path's shape is each kernel's first case
            head = rows[name][0]
            line.append(dict(
                name=name, route='cuda', source=meta['source'],
                replaces=meta['replaces'],
                launches=None if launches is None else launches[name],
                launches_by_path={p: c[name] for p, c in paths.items()},
                designs_by_path={p: d[name] for p, d in designs.items()
                                 if name in d},
                max_abs_err=max(r['max_abs_err'] for r in rows[name]),
                ms=head['ms'], plain_ms=head['plain_ms'],
                bound_ms=head['bound_ms'], bound_by=head['bound_by'],
                library_ms=head['library_ms'], shape=head['shape'],
                cases=rows[name]))
        if {'forward', 'serve', 'int8', 'train', 'ndarray', 'bert', 'resnet',
                'bf16', 'ring', 'rtc'} <= set(phases):
            idle = [k for k, n in launches.items() if n == 0]
            if idle:
                fail(f'kernels of the main path never launched: {idle}')
        log(f'[done] {time.perf_counter() - t_start:.1f} s')
        log(smi_line())
        log(json.dumps({'kernels': line}))
    if set(phases) == set(PHASES):
        log(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
