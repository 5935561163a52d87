#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``iotml_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --store-fit-orders N

Run from the repository root on a machine with a CUDA card and ``nvcc``.
With ``--store-fit-orders N`` it runs the device phase and then only
``store_fit_orders``: the params bound of ``store_path``'s fit from the
plain version alone on N orders of its rows, then B1 and the reversed
plain fit on each order against it, failing nothing.
Each phase prints one JSON line; any failure ends the run with a
non-zero exit and no result line:

1. device     — card name, count, ``nvidia-smi`` name and power limit;
                TF32 switched off for matmul and cuDNN.
2. build      — the three CUDA sources built from the checkout, one
                ``nvcc`` each, and the native stream engine (one ``g++``
                of ``iotml_torch/cpp``), started together (seconds per
                source;
                ptxas registers and spills per instantiation, a spill in
                a flash kernel or a rows fit kernel fails the run, and so
                does a missing split-TF32 instantiation, forward (four) or
                backward (eight); the fit kernel's
                shared memory per design at B=100; the flash kernels'
                shared memory per block, dtype and head dim; HGMMA
                instructions in the SASS of each ``wgmma`` instantiation,
                forward and backward, and HMMA…TF32 in each of the twelve
                split-TF32 ones, none fails the run; the fit kernel's
                design over a
                grid of shapes, the library's ``iotml_fused_fit_design``
                and ``fit_design``'s, and the design of each dtype and
                head dim in both attention directions, the libraries'
                and ``flash_design``'s; each pair must agree, and each
                direction must take all three designs).
3. kernel     — the fused-fit kernel against its plain PyTorch version on
                the card: the rows design at B=100, F=18 and F=30, 0/1
                and fractional masks, and at B=256 (its largest), F=30;
                the elements design at B=300, F=18 (each taken by
                ``fit_design``'s rule); 6 batches × 4
                epochs, ragged last batch; runs repeat bit for bit; 2 + 2
                epochs equal 4.
4. main_path  — the reference job at full width and shape: a 100-car
                fleet for 300 ticks (30,000 rows), train on 100 batches
                of 100 normal rows for 20 epochs (``fit_compiled``, one
                kernel launch, through the rows design), then score
                batches 100..199 (10,000 rows) with threshold 5, the
                payloads formatted by the native engine.
5. cli_path   — the same job through its own CLI,
                ``iotml_torch.cli.cardata.main``: ``train`` on
                ``emulator:30000`` (the in-process broker, Avro published
                and decoded by the native engine) to a temporary artifact
                root, then ``predict``.  Train launches the fit kernel
                exactly once, through the rows design (counts set to 0
                just before, read just after), losses finite and falling;
                the stored checkpoint restores to the trained state
                exactly and carries the committed cursor; predict writes
                10,000 payloads to ``model-predictions``, the first 100
                within atol 2e-6 of a CPU recompute from the restored
                params and all 10,000 within 1e-5 (index order), every
                payload the engine's string, byte-identical to
                ``np.array2string`` of the scored rows; the engine
                carried every decode, its decode of predict's 20,000
                messages equal to the pure codec's (``ops.avro``)
                exactly, and it formatted exactly the rows its fast path
                takes (``fastfmt.fast_rows``).  Train and
                predict seconds, ``fit_seconds``, decode and format
                seconds, scored rows/s, and ``format_rows`` against
                per-row ``np.array2string`` and the per-element plain
                version on those 10,000 rows.
6. serve_path — the long-lived scorer as deployed,
                ``iotml_torch.cli.serve.main``, on the card at full width
                (18 → 14 → 7 → 7 → 18, batch 100) from the cli_path
                checkpoint, over one ``emulator:30000`` broker shared by
                its calls: ``committed`` with threshold 5 scores all
                30,000 records, each payload with a ``|normal|`` or
                ``|anomaly|`` suffix, the first 100 within atol 2e-6 of a
                CPU recompute from the restored params and all 30,000
                within 1e-5 (index order), the committed cursor at the
                end offset; after 500 more records a second call scores
                exactly those 500.  A second process serves the same job
                from the command line's entry (``emulator:30000``, offset
                0) with its cold first forward.  Then a group drill: two
                ``GroupConsumer``s under card ``StreamScorer``s on a fake
                clock over a 10-partition topic of 30,000 records, both
                drain and commit the first half; one drains the second
                half of its share, crashes before committing, and after
                the session timeout the survivor takes its partitions:
                every offset scored at least once, every committed cursor
                at its end offset, duplicates only inside the crashed
                member's uncommitted drain (their payloads within atol
                1e-5 of the survivor's).  No kernel launches on this path
                (counts set to 0 before, read after).  Timings: each
                scorer's first super-batch forward apart, the drain's
                rows/s with and without it, host pipeline, device and
                formatting and write-back seconds, the resume round's
                seconds, and
                ``needs_resolution`` over the 30,000 records.
7. wire_path  — the same jobs over the Kafka wire protocol, as the deploy
                manifests run them: the port's ``KafkaWireServer`` on
                127.0.0.1:0 with SASL/PLAIN credentials over an in-memory
                broker seeded with ``emulator:30000``'s records;
                ``cardata`` train and predict with cli_path's argv apart
                from ``<servers>`` and the ``--broker.sasl_*`` flags (one
                fit launch, through rows; the stored params, moments and
                cursors equal cli_path's bit for bit; the 10,000
                payloads equal cli_path's byte for byte); ``serve ...
                committed`` over 30,000 records (serve_path's tolerances
                against a CPU recompute, the cursor at the end); two
                ``serve ... group`` members in threads, each with its own
                client, over 10 partitions of 30,000 records (every
                partition committed at its end, n ≤ scored ≤ 2n; the
                leg their batches took, ring, fused ``poll_decoded`` or
                message lists, counted in rows and equal to the leg the
                JAX package's ``SensorBatches`` takes for the same
                consumer, ``jax_sensor_leg``).  The
                write-back sends one PRODUCE request a non-empty flush;
                the consumers read through RAW_FETCH into the columnar
                ring: the RAW_FETCH and RAW_PRODUCE requests equal the
                client's own ``fetch_raw`` / ``produce_raw`` calls, and
                RAW_FETCH is not 0.  Train and predict seconds, the
                predict and serve drains' rows/s, the frame decoder's and
                the message-set codec's rows and seconds and the client's
                requests by API.
8. live_path  — the continuous services over the native Kafka client,
                on the port's ``KafkaWireServer`` (127.0.0.1:0, SASL/PLAIN)
                over ``emulator:30000``'s records: ``ContinuousTrainer`` on
                the card, a round of 20 × 100 normal rows at a time until
                the log holds no full round, each round exactly one fit
                launch through rows (counts read around it), its losses,
                accuracies, params and moments held against
                ``fused_fit_reference`` from the same start state and
                batches at the fit bounds; the pointer on the last round,
                committed cursors equal to positions.  ``LiveScorer`` from
                that pointer scores all 30,000 records with car health:
                payloads against a CPU recompute (first 100 at atol 2e-6,
                all at 1e-5), quality counts summing to 30,000, car-health
                records against a CPU ``CarHealthDetector`` fed the
                recomputed errors (states and sources equal, EMAs at rtol
                1e-5, wall-clock times aside); a second scorer without car
                health writes the same bytes.  Then ``python -m
                iotml_torch.cli.live train`` and ``score`` as two OS
                processes with ``--stats``, stopped by a STOP line once
                every record is scored and no round is left: at least 3
                rounds, 30,000 scored, at least one swap, both exit 0, no
                library rebuilt by a child.  Seconds a round and their
                split, rounds/s, records trained/s, the drain's rows/s
                with and without car health, ``fetch_decode`` rows and
                seconds beside the server's encoded rows.
9. creditcard_path — the creditcard fraud job through
                ``iotml_torch.cli.creditcard.run`` on the card at the Kaggle
                file's row count (``synth:284807``; epochs 5, batch 32,
                threshold 5, the CLI's own): exactly one fit launch, through
                the rows design at (F, E, H) = (30, 14, 7), B = 32, over
                ~42,300 steps; the losses falling; the kernel held against
                the plain version from the same start state on the first
                500 of the same batches (the fit bounds); the card's
                scores within rtol 1e-5 of a CPU recompute from the card's
                params, and the report's AUC and AP within
                ``ranking_tolerance`` of the CPU's (the pairs whose scores
                lie within that tolerance of each other, the only ones
                that can swap); AUC > 0.9.  CSV, produce, batching, fit,
                kernel and scoring seconds, ``reconstruction_errors``
                rows/s.
10. lstm_path — the supervised LSTM through ``iotml_torch.cli.lstm.main``
                on ``emulator:30000`` (18 features, 32/16/16/32 units, 15
                batches of 64 windows × 5 epochs, then 3 batches
                predicted): the card's losses and checkpointed params
                against the same train on the CPU (the fit bounds); the
                192 payloads, in index order, within atol 1e-5 of a CPU
                recompute from the restored checkpoint; no kernel launch.
11. mnist_path — ``iotml_torch.cli.mnist_smoke.run(["--n", "60000"])``
                on the card: ingestion intact, both models' losses
                falling; the classifier's first 50 steps against a CPU run
                from the same init (loss and accuracy rtol 1e-4, params at
                the fit bounds); no kernel launch.
12. lifecycle_path — the model lifecycle (ROADMAP A5) on the card at
                full width: ``cardata`` train to ``model1.h5`` on
                ``emulator:30000`` (one fit launch, through rows), the
                stored file opened by the port's HDF5 reader
                (``utils.hdf5``: its attributes the exporter's strings
                byte for byte, its datasets the trained params bit for
                bit), then predict from it (10,000 payloads against a
                CPU recompute from the trained params, cli_path's
                bounds; the imported params bit-equal to them); h5
                encode and decode ms and the file's bytes.
                Then the live services in registry mode over the native
                client on the port's wire server: an uninterrupted
                ``ContinuousTrainer`` (an ``AsyncCheckpointer`` writer
                thread, every round a committed version) until the log
                holds no full round (at least 6 rounds of 20 × 100, one
                fit launch through rows each); the same run again in a
                second registry and group, crashed after round 3 (the
                writer stopped before round 3, so round 3's snapshot is
                lost), ``recover()``, and a new trainer that resumes v2's
                ``state.npz`` (step, count and cursors the manifest's)
                and re-trains round 3 on; after
                every round the group's committed offsets at or below
                the newest durable manifest's; the final state within
                rtol 1e-4 / atol 1e-7 of the uninterrupted run's, the
                final offsets equal and committed; a registry-following
                ``LiveScorer`` draining 1,000 rows between rounds ends on
                the tip with all 30,000 records scored once, the rows
                after its last swap against a CPU recompute from the
                final trained params (serve_path's bounds; the tip's
                imported model.h5 bit-equal to them); ``restore_trainer``
                from the tip
                equal to the final state.  Then an ``ABRollout`` of the
                tip against the tip + N(0, 1) noise (seed 7) with
                ``deploy_candidate`` and ``RolloutGate(min_records=300,
                epsilon=0.02)``: the verdict ``rollback``, serving back
                on the tip, the serving scorer swapped to the candidate
                and back, both sides' 30,000 rows on their topics.  No
                launch in restore, watcher or rollout.  Snapshot ms,
                write ms (serialize, fsync), seconds a round beside
                live_path's, resume and restore seconds, promote-to-swap
                and rollback-to-swap seconds, the A/B rows/s.
13. online_path — online learning (ROADMAP A8) on the card: ``python -m
                iotml_torch.online drill --seed 7 --json`` (12,000 records,
                50 cars, window 50) through its entry point on the card,
                then on the CPU in the same run; the two must agree on
                every invariant's name and outcome, the detection delay,
                the published and scored counts, the adaptations (update,
                signal, action), the published versions and the
                hot-swaps, and on the histogram AUCs within 0.01 — the
                verdict itself may be FAIL where both fail, as JAX's
                does at seed 7 (``adaptation_converged``); the drill
                launches B1 once for its pre-train plus each refit's
                launches.  Then an ``OnlineLearner`` with
                ``AdaptationPolicy(action="refit")`` on
                tests/test_online.py:344's regional-drift stream at window
                100 (50 cars): at least one refit; each refit launches B1
                exactly ``refit_launches(windows)`` times (the counts set
                to 0 just before, read just after) and its params, moments
                and ``last_loss`` match a plain step-loop refit from the
                same state on the card (params rtol 5e-3 / atol 2e-5,
                loss rtol 2e-4 / atol 1e-6).  Then ``python -m
                iotml_torch.online run`` as a process over the port's wire
                server (127.0.0.1:0, LIVE_RECORDS records) with
                ``--registry``: at least one version, the committed offsets
                at or below the newest manifest's, no library rebuilt.
                Windows/s and ms a window by group size, ms a refit,
                publishes, ``offsets_lag`` and swaps; the learner's
                catch-up records/s (groups of 8 windows of 100, native
                client) beside ``ContinuousTrainer``'s over the same
                backlog, and their ratio (printed, not gated).
14. obs_path   — the observability plane (metrics, tracing, watermarks,
                fault points, profiler) on the card, at the main path's
                width (30,000 fleet rows, 18 → 14 → 7 → 7 → 18, batch
                100): (1) the fleet published with birth headers, a
                ``fit_compiled`` over a consumer (one B1 launch) and a
                ``StreamScorer`` drain of the 30,000 rows under tracing,
                the span log's stages (publish, consume, train, score)
                and e2e closes counted exactly (score closes = rows) with
                each stage's p50/p99, params and payloads equal to an
                untraced run's bit for bit; (2) ``cli.live train`` and
                ``score`` as processes with ``--metrics-port``, scraped
                over HTTP while they run and at the end:
                ``live_train_rounds_total``, ``records_trained`` and
                ``records_scored`` equal to the processes' own ``--stats``,
                ``/healthz`` with the consume/train/score watermarks and
                stage liveness; (3) ``obs.profile.trace`` around one fit,
                one ``ContinuousTrainer`` round and one serve drain, each
                window's device busy share (the union of device
                intervals) and top 5 device operations; (4) a
                ``ChaosEngine`` armed in-process: ``scorer.poll`` raises
                once (one rewind, every row scored, duplicates counted),
                ``trainer.poll`` is delayed and ``ckpt.write`` raises once
                over four registry rounds (one B1 launch each), the final
                params within rtol 1e-4 / atol 1e-7 of an unfaulted run's,
                the hit and fire counts equal to a CPU run of the same
                schedule; (5) the serve drain and the fit timed with
                tracing off and on, in turns (off, on, on, off, twice).
14b. telemetry_path — the telemetry plane watching B1's live rounds: (a)
                ``cli.live train`` and ``score`` as processes on the card
                with ``--metrics-port`` and ``IOTML_OBS_ENDPOINTS`` (each
                publishes itself into the run's manifest), fed 10 times
                2,300 records 1.5 s apart; a ``FleetServer`` over the
                manifest scrapes them every 0.25 s into a ``TsdbAppender``
                on a durable broker (5 s chunks), in turns attached and
                not (off, on, on, off, ...), and an ``SloEngine`` over
                ``iotml_step_seconds{loop="train"}`` and the records-trained
                counter runs as a supervised unit.  ``iotml_cluster_up``
                sums to 2; the TSDB's ``rate(...records_trained_total
                [20s])`` and ``histogram_quantile(0.99, ...)`` of the
                train loop equal a recompute from the kept texts (relative
                1e-12); the TSDB's trained and scored counts equal the
                processes' ``--stats``; each process prints its own B1
                launches at exit: one a round, all rows, at least 5
                rounds; no alert fires; after one forced compaction
                ``_IOTML_TSDB`` holds one record per (series, window).
                Scrape-and-append ms and records, query and SLO
                evaluation ms, seconds a round with the plane attached
                and not.  (b) the alert-burn drill at its defaults through
                its CLI (``python -m iotml_torch.obs tsdb drill --json``)
                in a process of its own, the scorer on the card: every
                invariant passes (the fast
                pair fires in budget, lands on ``_IOTML_ALERTS`` and both
                ``/healthz``, resolves); time to fire and to resolve.  (c)
                ``Platform(cc_port=0)`` one fleet tick old:
                ``/api/status``'s topics equal the broker's begin and end
                offsets; the generated dashboard has a panel for every
                family registered by then; a ``ScalarLogger`` writes the
                live fit's history and its JSONL reads back equal.
15. ksql_path  — the reference's KSQL stage (L4) on the card's host
                feeding B1, set up as the platform does on loopback: the
                port's in-process broker with a 4-partition
                ``sensor-data``, a ``SchemaRegistry`` holding the two car
                subjects behind its REST server, a ``KafkaWireServer``
                and a ``KsqlServer`` on 127.0.0.1:0,
                ``restrict_topic("SENSOR_DATA_S_AVRO")`` and a trusted
                ``SqlEngine`` holding the owner's token (sampling one
                pass-through batch in 32).  ``REFERENCE_PIPELINE_DDL``
                POSTed to ``/ksql``; one tick of a 100,000-car fleet as
                JSON (``json.dumps(gen.row_record(...))``) under the MQTT
                bridge's keys; ``pump_now`` until a round emits nothing,
                each leg timed apart (JSON→AVRO, REKEY, CTAS records/s)
                and the rows its native legs handed to Python counted.
                SENSOR_DATA_S_AVRO and its REKEY hold 100,000 records,
                the CTAS table 100,000 keys each counted once, ``SHOW
                QUERIES`` no error, ``GET /subjects`` the AVRO legs'
                subjects and every frame the registry's id; the first
                2,000 records of each leg equal to ``process_plain``'s
                (the pure Python leg) byte for byte; a wire produce to
                SENSOR_DATA_S_AVRO refused with error 29, the end offsets
                unmoved.  Then 100 batches of 100 normal rows from the
                AVRO leg — equal exactly to the batches of the same rows
                published straight as Avro — fit for 20 epochs
                (``fit_compiled``: one B1 launch, through rows) and held
                against the plain version at the fit bounds; the kernel
                timed again alone; the scorer over all 100,000 records
                into ``model-predictions`` with the threshold at the 99th
                percentile of 512 normal rows' errors (the demo's),
                payloads against a CPU recompute (first 100 at atol
                2e-6, all at 1e-5).  The in-memory stage takes no raw
                produce leg (as JAX's); the same stage again on a
                durable broker ships every JSON→AVRO record as
                RAW_PRODUCE batches (counted), and both AVRO legs' topics
                equal the in-memory stage's record for record.
16. demo_path  — the reference's whole story as users run it: (a)
                ``iotml_torch.cli.demo.main([])`` in-process on the card
                at its defaults (50 cars at 10 Hz for 8 s over MQTT TCP
                → bridge → KSQL → fit → checkpoint → artifact store →
                scorer → report), stdout captured and its JSON summary
                parsed: the JAX demo test's invariants (records bridged,
                every one on SENSOR_DATA_S_AVRO and scored, the last
                loss at most the first), the JAX CLI's summary keys, and
                exactly one B1 launch, through rows; (b) one tick of the
                reference's 100,000 cars (its only cut), published from
                the phase's own thread over 64 ``MqttClient``
                connections (car i on connection i % 64, QoS 0, as
                ``start_fleet`` does) into ``Platform(partitions=4)``'s
                epoll front, bridged into sensor-data (a deadline fails
                the phase), then the same tick through the native ingest
                front onto a second broker and into a wire client of
                the port's server (the bridge's raw leg: frames once,
                RAW_PRODUCE, as JAX's; checked engaged), then both
                fronts again with one ``publish_many`` (one sendall) a
                connection: each front's sensor-data equal to
                ``_ksql_fleet_json``'s straight publish as a multiset a
                partition and per key in offset order; the KSQL pump;
                SENSOR_DATA_S_AVRO's rows in their keys' order equal to
                the straight-Avro batches; 100 batches of 100 normal
                rows in the fleet's own order (the interleaving of the
                64 connections) fit for 20 epochs in one B1 launch, its
                losses, accuracies and moments held against the plain
                version at the fit bounds and its params against the
                float64 fit within the float32 order noise of the plain
                version on 6 orders of those rows (``order_noise_bound``,
                derived first), and all 100,000 rows scored against a
                CPU recompute (as ksql_path).  Publish and bridge records/s
                of each front, the epoll front's paused connections and
                evictions, pump seconds, fit and kernel ms, scored
                rows/s.
17. store_path — the durable commit log under the main path, at the
                reference topic's size: one retention window (100,000
                cars at one message per 10 s, scenario.xml:48-49, over
                10 partitions with retention.ms=100000,
                01_installConfluentPlatform.sh:180-183: ten ticks,
                1,000,000 Avro records of ~195 bytes a frame).  (a)
                Appended tick by tick through the fused ``produce_many``
                into ``Broker(store_dir=D)`` under the store.* defaults
                (16 MiB segments, fsync=interval); retention drops
                nothing; records/s and MB/s, segments a partition, the
                engine's framing rows; one tick again under fsync=never
                and fsync=always (one call, and calls of 1,000) in fresh
                directories.  (b) A child process mounts D and appends
                tick 11 with fsync=always in calls of 10,000, committing
                and printing each call's ends; SIGKILLed after 4 acks
                (a deadline fails the phase); a mount writes a torn
                frame on partition 3's active segment and is dropped
                without close(); the remount's seconds; every record
                served (all acked ones among them) equal to the seeded
                generator's by regeneration, the truncated-bytes counter
                grown by the torn frame at least, the group's commits
                read back; replay records/s.  (c) 100 batches of 100
                normal rows from offset 0, read through the columnar
                ring (a ``DecodeRing``, ``FrameDecoder`` calls, decoded
                rows in ``native.stats``, no chunk fallen back) →
                ``fit_compiled`` for 20 epochs (one B1 launch, rows), its
                losses, accuracies and moments held against the plain
                version at the fit bounds and its params against the
                float64 fit within the params bound derived first from
                the plain version alone (``order_noise_bound``: the
                largest drift from float64 of 54 float32 fits, 6 row
                orders × each batch's rows as given and in 8 shuffles),
                and bit for bit against the same fit from an in-memory
                broker holding the same records (the batches exactly
                equal); 10,000 rows scored, through the ring,
                into the durable model-predictions (threshold at the
                99th percentile of 512 normal rows' errors), read back
                equal after a remount and held against a CPU recompute
                (first 100 at atol 2e-6, all at 1e-5).  (d)
                ``ContinuousTrainer(backfill_since_ms=tick 5's ms)``:
                each partition starts at ``offset_for_timestamp`` and at
                a linear scan's first record; three rounds, one B1
                launch each.  (e) The window again on a
                cleanup_policy="compact" topic with 1 MiB segments and a
                tombstone for one car in 1,000; every partition rolled;
                one forced pass leaves exactly the newest record per key
                at its offset (a dict reference), tombstones inside the
                grace window kept; seconds a pass, bytes reclaimed.  (f)
                D remounted with a tier (a local directory) whose hot
                budget is one segment: one tiering pass uploads and
                evicts the head; the fit's batches through the remote
                tier equal (c)'s, one B1 launch equal to (c)'s bit for
                bit; upload MB/s, remote-read records/s.  (g)
                ``Platform(store_dir=D2)``: one tick of 20,000 cars over
                64 MQTT connections into the bridge and KSQL, stopped; a
                second Platform on D2 re-serves SENSOR_DATA_S_AVRO whole
                and one B1 launch fits on it.  (h) the ring on the
                recovered window: once at the default 1 MiB raw fetch
                (the chunks fallen back to the message-list leg
                counted), then at 4 MiB every record through
                ``SensorBatches`` on the ring (no fallback) and through
                the per-record leg decoding with the pure codec, the same
                rows, labels and keys in the same order a partition,
                records/s of each; partition 0 alone through both, its
                batches equal (values, labels, keys, masks,
                boundaries); a replay from
                tick 5 by ``seek_to_timestamp`` + ``poll_into`` equal to
                each partition's rows past the cut; one tick over
                RAW_PRODUCE through a ``KafkaWireServer`` on a durable
                broker from the pure and the native client, segments
                byte-identical to the classic ``produce_many``'s,
                records/s; one RAW_FETCH a partition equal to
                ``fetch_raw``.  Each sub-phase's frame engine rows and
                seconds (``native.stats``).
17b. replication_path — replicated durability (ROADMAP A14) under the
                main path, after store_path in the same temporary root, at
                the reference's RF-3 (01_installConfluentPlatform.sh:
                180-183): (a) a leader ``KafkaWireServer`` on a durable
                store and a ``ReplicaSet`` of 2 followers, each on a store
                directory of its own (min_isr 2, max_lag_s 0.5), the
                ISR formed on all 10 partitions; (b) one tick of the
                reference's 100,000 cars, Avro-encoded, shipped to
                SENSOR_DATA_S_AVRO over RAW_PRODUCE (``RawBatchProducer``)
                at acks=-1, in chunks of ``IOTML_PRODUCE_BATCH_BYTES``;
                (c) acks=all and acks=1 records/s, each the median of 3
                runs in turns, and the overhead; then the cardata CLI's
                ``train`` against the leader's host:port (one B1 launch);
                (d) one follower killed abruptly, one acks=all chunk a
                partition (acked once the ISR re-forms without it), the
                leader killed with no drain, an ISR follower elected and
                promoted at epoch 1, published through the ``Topology``;
                (e) every acked record on the new leader byte for byte at
                its offset (each partition's log bytes equal the frames
                of what was acked, and the old leader's), a resurrected
                old leader answering FENCED (74) to produce, raw produce
                and commit with nothing appended; (f) the same CLI
                ``train`` against the new leader: one B1 launch whose
                checkpoint (params, mu, nu, step, cursors) equals the
                pre-kill one bit for bit, and its losses and moments
                against the plain version on the batches rebuilt from
                the promoted log (``check_fit``); a new follower added
                over RAW_FETCH, its catch-up seconds and MB/s; (g)
                ``python -m iotml_torch.replication drill --name
                double-fault`` and ``python -m iotml_torch.supervise
                drill --all`` in-process at their defaults (seed 7), both
                exit 0, the leader-kill trainer's B1 launches counted.
                Records/s, time-to-promote, the drills' SLOs and B1
                launches by sub-phase.
17c. cluster_path — the partitioned cluster (ROADMAP A14) under the main
                path, after replication_path in the same temporary root,
                at the reference's deployment (2 topics × 10 partitions
                × RF 3 on 3 brokers, min_isr 2; SURVEY.md:342,
                01_installConfluentPlatform.sh:180-183, gcp.yaml:46-54),
                through the cluster's own command line: (a) ``python -m
                iotml_torch.cluster up --brokers 3 --partitions 10
                --replication-factor 3`` as a child on durable stores, its
                bootstrap line read, the ISR formed (``status`` over
                CLUSTER_ADMIN); (b) one tick of the reference's 100,000
                cars as Avro records through ``ClusterClient(bootstrap=)``
                at acks=all, in requests of one partition's records cut at
                ``IOTML_PRODUCE_BATCH_BYTES``; (c) the cardata fit, its 100
                batches of 100 normal rows read by ``SensorBatches`` over a
                ``StreamConsumer`` on the routed client (RAW_FETCH to each
                owning shard, the columnar ring), ``fit_compiled`` for 20
                epochs: one B1 launch through rows, held to the plain
                version (losses and accuracies, mu and nu, the step count)
                and its params to the float64 fit within the order-noise
                bound of 9 float32 fits; (d) while tick 2 is produced in
                chunks (redelivered on the refusals a move brings) and
                tailed by a consumer, ``add-broker --shard 1`` then
                ``drain-broker --shard 2`` as children: both retired, the
                new node's catch-up over RAW_FETCH; (e) the refit from
                offset 0 after the moves: its batches byte-equal to (c)'s,
                then params, mu, nu, losses and step bit-equal; (f) a
                3-member ``ScorerFleet`` on the card scores both ticks:
                each (partition, offset) exactly once (the members' fetch
                and decode calls name them), and each member's first
                payloads against a CPU recompute (atol 2e-6 the first
                100, 1e-5 the rest); (g) ``python -m iotml_torch.cluster
                drill --seed 7`` and ``python -m iotml_torch.replication
                drill --name reassign`` in-process, both exit 0.
                Records/s, catch-up and move seconds, the tail's longest
                stall, the fit seconds, the fleet's rows/s, the drills'
                SLOs and B1 launches by sub-phase (2).
17d. chaos_path — the chaos runner, the mlops drills and the supervised
                platform (ROADMAP A14) on the card, after cluster_path:
                (a) every ported scenario through ``python -m
                iotml_torch.chaos run --scenario S --seed 7 --records N
                --json`` in this process at the JAX package's CI sizes
                (2,000 records; 500 for broker-crash-recover,
                tier-upload-crash and double-fault), each with the launch
                counts set to 0 just before and read just after:
                loss-bug-fixture must fail ``scored_or_accounted`` (exit
                1), drift-storm is held to the port's CPU run of the same
                scenario (at seed 7 both packages end it still adapting),
                every other scenario passes; B1 launches in
                trainer-crash-mid-checkpoint (one a round) and
                rollout-regression-rollback (the baseline's round), and in
                no other; alert-burn (600
                records) as a child process; (b) ``python -m
                iotml_torch.mlops drill --all --seed 7`` in this process:
                the swap and rollback seconds against their SLOs (5 s,
                60 s), one B1 launch (the rollback's baseline); (c)
                ``Platform.supervised(poll_interval_s=0.02)``: the KSQL
                pump thread killed and its restart timed, the attached
                checkpoint writer crashed once at ``ckpt.write`` and the
                snapshot still queued published after its restart with
                the trainer's params bit for bit, then ``python -m
                iotml_torch.cli.up --supervise`` as a child printing its
                6 units and stopped by Ctrl-C; (d) the first
                trainer-crash round's B1 launch held against the plain
                version on its rows (``check_fit``), and every payload of
                the rollback drill's production scorer within atol 1e-6
                of a CPU recompute (the baseline's forward, then the
                candidate's at atol 1e-5, then the baseline's
                again).  Scenario
                seconds, injected counts and verdicts, B1 launches by
                scenario.
17e. twin_path — the sinks and the digital twin (ROADMAP A16a) on the
                card, after chaos_path: (a) ``python -m iotml_torch.twin
                drill --seed 7 --records 1500`` through its ``main`` in
                this process, exit 0 and its five invariants printed as
                PASS; (b) ``python -m iotml_torch.chaos run --scenario
                compaction-under-crash --seed 7 --records 500``, verdict
                PASS; (c) 100,000 cars x 2 ticks (seed 7) into
                SENSOR_DATA_S_AVRO's 10 partitions on a durable broker,
                folded tick by tick by a ``TwinService``, its CAR_TWIN
                changelog rolled and compacted, a second service rebuilt
                from it with a snapshot byte-equal to the first's, and
                ``GET /twin/<car>`` over ``ConnectServer.attach_twin``
                for 1,000 cars, each equal to ``TwinService.get``; (d)
                the first 100 batches of 100 normal rows joined with
                ``TwinFeatureStore.matrix`` of their keys (38 columns)
                fit for 20 epochs by ``fit_compiled``: exactly one B1
                launch, through "elements" (the counts 0 just before),
                held against the plain version (``check_fit``), then
                kernel and plain timed; (e) ``StreamScorer(feature_store=
                TwinFeatureStore(...), verdict_mask=np.ones(18, bool))``
                over all 200,000 rows: rows scored and the predictions'
                end offset 200,000, payloads against a CPU recompute of
                the same joined rows (atol 2e-6 the first 100, 1e-5
                all), the printed errors the live columns' mean (within
                2e-6, and away from the joined row's), no kernel
                launched; then the same scorer unjoined over the same
                rows.  Fold, rebuild and scoring rates, changelog and
                compaction counts, query p50/p99, the fit's kernel and
                plain ms.
17f. gateway_path — the gateway serving plane (ROADMAP A16b) on the
                card, after twin_path: (a) ``python -m iotml_torch.gateway
                drill --seed 7 --records 1500 --cars 30`` and ``--seed 11
                --records 2000 --cars 40 --json``, once each, through
                its ``main`` in this process, each exit 0 with its six
                invariants PASS (promote and staleness seconds, the storm's
                queries and p99, the delta replay); (b) ``python -m
                iotml_torch.gateway fleet`` at its defaults (100,000 cars,
                2 front processes, 2 ticks, 2 shards, 8 partitions, seed
                20): 200,000 published and folded, 100,000 cars served,
                every front's lookups answered, both fronts native, the
                payloads encoded by ``NativeCodec``; (c) 20,000 cars x 2
                ticks (seed 7) into SENSOR_DATA_S_AVRO's 8 partitions,
                served by a ``GatewayCluster`` of 2 shards with standbys
                and by a reference ``TwinService(changelog=False)``:
                ``GatewayClient.matrix`` bit-equal to
                ``TwinFeatureStore.matrix`` for every batch's keys; the
                first 100 batches of 100 normal rows joined through each
                store fit for 20 epochs from one start state, exactly two
                B1 launches, both "elements" (the counts 0 just before),
                params bit-equal, the gateway's held against the plain
                version (``check_fit``); ``StreamScorer(feature_store=
                GatewayClient(...))`` over all 40,000 rows, shard 0 killed
                and promoted after the first call (25,600 rows), payloads
                byte-equal to the same scorer's through the local store
                and the first 100 against a CPU recompute; no kernel in
                (a), (b) or the scorers.  Rows/s through either store,
                the fleet's seconds and records/s.
17g. analysis_path — the analysis tooling (ROADMAP A13) on the card's
                machine, after gateway_path: (a) ``python -m
                iotml_torch.analysis all`` and ``... lockorder`` as child
                processes, exit 0 with 0 findings and 0 static cycles
                (wall seconds, files parsed, edges); (b) the build guard
                (``tracecheck.install_runtime_guard``) armed over
                ``Trainer.fit_compiled`` and ``OnlineLearner._update``:
                ``fit_compiled`` twice on the main slice (18→14→7→7→18,
                100 batches of 100 rows, made anew from main_path's
                fleet, 20 epochs) from one trainer, and
                ``_update`` twice on two 100-row windows; 0 builds or
                loads after each warm-up, exactly two B1 launches, both
                "rows", none from the updates (the counts 0 just before),
                each fit held against the plain version from its start
                state (``check_fit``); each warmed call's count of
                synchronizing CUDA calls under
                ``torch.cuda.set_sync_debug_mode("warn")``, printed and
                not gated; (c) a child process that installs the port's
                lockcheck pre-seeded with the static edges before any
                broker exists, then drains 100 cars x 30 ticks through a
                ``KafkaWireServer``, a wire ``GroupConsumer`` and the
                card's ``StreamScorer``: every record scored, 0 lock-order
                cycles (its io-under-lock and unguarded-mutation counts
                printed).  The three children run beside (b).  The guard
                also wraps ``ShardedStreamTrainer.fit_round`` and
                ``fit_compiled``, which (b) does not call.
17h. mesh_path — data parallelism (ROADMAP A10) after analysis_path,
                ``[cuda:0, cuda:0]`` as the data axis (two logical shards
                on the one card): (a) ``ShardedTrainer.fit`` on the main
                slice (18→14→7→7→18, 100 batches of 100, 2 epochs)
                against the single-device ``Trainer.fit`` of the same rows
                and init, losses and params at rtol 1e-4 / atol 1e-6, ms a
                step for 2 shards, 1 shard and the Trainer; (b)
                ``ContinuousTrainer(mesh=, device_normalize=True)`` in
                registry mode over a durable 8-partition broker (100 cars
                x 80 ticks), three rounds of 10 batches a feed: one
                manifest a round stamping all 8 cursors, each round's
                loss and params against the same rounds on two CPU
                shards (the fit bounds); (c) ``OnlineLearner(mesh=,
                chip_monitors=)`` over two windows, the loss and the
                per-device losses against a CPU learner's at rtol 1e-5;
                (f) ``bench_leg(2)`` (40,000 timed records), its
                records/s printed beside the card, not gated and not a
                scaling figure; then (d) ``python -m
                iotml_torch.parallel.multihost_worker`` as two ranks on
                the card over gloo (CUDA tensors) and as one rank over
                NCCL, started together, each rank's ``MULTIHOST ... ok``
                line, equal trajectories across ranks, each within rtol
                1e-4 of an in-process CPU recompute, while (e) the
                cardata CLI trains through ``main(argv,
                devices=[cuda:0, cuda:0])`` with ``--mesh.data=2`` (its
                20 epochs cut to 2, to keep the phase short)
                and prints JAX's ``mesh: {'data': 2, 'model': 1} over 2
                devices`` line, and ``IOTML_MESH_DATA=2`` with the default
                device list refuses with JAX's ValueError on a one-card
                machine.  Every launch count 0 just before (a) and read
                just after (e): no kernel on this path.
18. fit_orders — after store_path's launch counts are read: its rows in
                6 orders, B1 and the plain version with each batch's
                rows reversed fit for 20 epochs on each, both held to
                store_path's params bound against each order's float64
                fit (an order outside fails the run); B1 against the
                plain version at the fit bounds reported.  These B1
                launches compare the kernel with its plain version and
                count on no path.
19. timing     — each design held against the plain version over the
                whole fit at that shape (all 20 epochs' loss and
                accuracy, the final params, mu and nu), then each
                design's time per fit (CUDA events over warm launches,
                timed in turns: rows, elements, elements, rows) beside
                the plain version's, the autograd step loop's
                (``fused="never"``), the bound and the one-SM bound (the
                same flops at one SM's share of the fp32 rate: a fit is
                one block); the same again at B=256 on the same fleet
                slice (39 batches, 20 epochs).
20. attention_kernel — the flash-attention kernel against its plain
                version on the card, both entry points, O and LSE: f32
                D=8 (causal T=40 with blocks 16, non-causal T=32), f32
                D=16 (causal, B=2, H=4, T=4096), bf16 D=128 H=2 (causal
                T=1000, non-causal T=1024); then the split-TF32 design's
                cases (f32 D=8 and 16, causal and full, T = 1, 15, 16,
                17, 63, 64, 65, 127, 128, 129, 1000 and 4096 at B·H = 1
                and 6, the plain version at blocks 128 when causal and at
                block T when full), each checked to take the
                ``mma_tf32x3`` design, O and LSE at rtol = atol = 2e-5,
                their largest O and LSE errors apart; then the
                tensor-core design's cases (bf16 D=128, the plain
                version at blocks 64, the kernel's key tile: causal
                T = 1, 63, 64, 65, 127, 128,
                129, 1000, 4096 at B·H = 1 and 6, non-causal T = 64 and
                1024 at B·H = 6, and non-causal T = 1,040 with the
                caller's block 16, a ragged key tile), each checked to
                take the ``wgmma`` design, their largest O and LSE errors
                apart; the ``wgmma`` design is held by
                ``flash_parity.check_wgmma_forward`` (O element by element
                and row by row), which must fail its O scaled by 0.9,
                whole or in its last row; a second launch repeats the
                first bit for bit; a ragged non-causal call raises.
21. sensorformer_path — SensorFormer at full width (its defaults) scores
                100 cars' 4,096-tick fleet histories: one forward with
                attn_mode="flash" (2 causal kernel launches), held
                against the same weights with the kernel's plain version
                (all cars) and dense attention (4 cars); forward ms and
                scored steps per second.
22. attention_timing — kernel, plain version, bound and the library
                yardstick (``scaled_dot_product_attention``) at the
                model's per-layer call (f32, B=100, T=4096, H=4, D=16)
                and the long-context shape (bf16, B=1, T=65,536, H=2,
                D=128; plain version at blocks 1024), causal and not;
                each line with the kernel's design and achieved TFLOP/s
                (its bound's flops over its time).  The bound
                (``attention_bound``) is the larger of the bytes over the
                memory rate and the flops on the tensor cores: bf16 at
                its peak, f32 as split TF32 (3 × the flops at the TF32
                peak); beside it the fp32 FMA floor and the ex2 floor.
23. attention_backward_kernel — the dK/dV and dQ kernels against the
                plain backward on the card, both entry points, dq, dk and
                dv: the attention_kernel shapes with a seeded random dO,
                then the split-TF32 design's cases (f32 D=8 and 16,
                causal and full, T = 1, 15, 16, 17, 63, 64, 65, 1000 and
                4096 at B·H = 1 and 6, each checked to take the
                ``mma_tf32x3`` design), then the tensor-core design's
                cases (bf16 D=128, plain
                blocks 64: causal T = 1, 63, 64, 65, 1000, 4096 at
                B·H = 1 and 6, non-causal T = 64 and 1024 at B·H = 6,
                causal B=2 H=2 T=4096), each checked to take the
                ``wgmma`` design, those of T ≥ 1000 again on inputs
                rounded to a 1/4 grid, and a call that needs only dk (no
                dQ launch); at the f32 D=8 shapes also against autograd
                through the dense reference; a bf16 row outside the
                tolerance passes only as one p or ds rounding flip
                (``flash_parity.bwd_rounding_flips``, none on the grid),
                and each flip is printed; a second launch repeats the
                first bit for bit; a ragged non-causal call raises.
24. sensorformer_train — the slice's main path: ``make_sp_train_step``
                Adam steps (lr 1e-3) of SensorFormer at full width on the
                fleet histories of phase 21; each step launches exactly
                ``num_layers`` causal forwards, dK/dV and dQ kernels; step
                1's loss and every parameter's grad held against the same
                weights with the plain versions (all cars) and dense
                attention (4 cars); losses finite and falling; step ms
                and trained steps per second.
25. attention_backward_timing — each backward kernel, the plain
                backward, the port's forward + backward and the library's
                (``scaled_dot_product_attention`` through autograd) at the
                shapes of phase 22, beside the bound, the fp32 FMA floor
                and the ex2 floor; each kernel's design and achieved
                TFLOP/s (its bound's flops over its time),
                and ``flash_attention_fwd_bwd_tokens_per_sec`` (T over the
                port's forward + backward seconds, as bench.py's
                long-context line).  The port's forward + backward is the
                long-context path: ``flash_attention`` through autograd,
                its forward in the design ``flash_design`` names (the
                tensor-core one at bf16 D=128); one such call runs with
                every launch count set to 0 just before it and read just
                after (exactly one forward, one dK/dV and one dQ launch).
Then the kernels line (the fit's design, and its launches by design on
the main path and by path, the main path, the CLI path, the serve path
(none), the wire path, the live path (one a round), the lifecycle path
(one for the CLI train and one a registry round), the online path (the
drill's pre-train and every refit's), the obs path (two traced fits,
two captures, eight chaos rounds, eight timed fits), the KSQL path
(one), the demo path (two: the demo CLI's and the tick's), the store
path (seven, by sub-phase in ``store_path_launches_by_subphase``), the
replication path (by sub-phase), the cluster path (two: the fit and the
refit, by sub-phase in ``cluster_path_launches_by_subphase``), the
chaos path (by scenario in ``chaos_path_launches_by_scenario``), the
creditcard path (one), the LSTM and MNIST paths (none), summed in
``launches``; the creditcard fit's time, steps and bound beside; each attention entry's
design at the layer call and the long-context call; ``launches`` sums the
counts read on the paths that run the entry: the SensorFormer forward
(phase 21), the training steps (phase 24), the long-context forward +
backward (phase 25) and the serve, creditcard, LSTM, MNIST and online
paths (none), each also given by path),
the ``nvidia-smi`` line, and the result line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import http.client
import inspect
import io
import json
import math
import os
import queue
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from iotml_torch.analysis import lockcheck, lockorder, tracecheck
from iotml_torch.chaos import faults as obs_faults
from iotml_torch.cli import _app as cli_app
from iotml_torch.cli import cardata
from iotml_torch.cli import creditcard as creditcard_cli
from iotml_torch.cli import demo as demo_cli
from iotml_torch.cli import lstm as lstm_cli
from iotml_torch.cli import mnist_smoke as mnist_cli
from iotml_torch.cli import serve as serve_cli
from iotml_torch.cli.up import Platform
from iotml_torch.cluster import ClusterClient, ScorerFleet
from iotml_torch.connect import ConnectServer, ConnectWorker
from iotml_torch.core.normalize import CAR_NORMALIZER
from iotml_torch.core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA
from iotml_torch.data import pipeline
from iotml_torch.data.dataset import Batch, RowSource, SensorBatches
from iotml_torch.data.mnist_stream import synth_mnist
from iotml_torch.evaluate import anomaly
from iotml_torch.gateway import GatewayClient, GatewayCluster
from iotml_torch.gateway import drill as gateway_drill
from iotml_torch.gateway.__main__ import main as gateway_cli
from iotml_torch.gen.scenarios import AdversarialFleet
from iotml_torch.gen.scenarios import condition as scenario_condition
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.mlops import (ABRollout, AsyncCheckpointer, ModelRegistry,
                               RolloutGate, restore_trainer)
from iotml_torch.mlops.checkpoint import (params_from_h5_bytes,
                                          params_to_h5_bytes)
from iotml_torch.models import h5_export
from iotml_torch.models.autoencoder import (CAR_AUTOENCODER, AutoencoderSpec,
                                            CREDITCARD_AUTOENCODER,
                                            PARAM_NAMES, reconstruction_error)
from iotml_torch.models.convert import params_to_jax
from iotml_torch.models.h5_import import autoencoder_params_from_h5
from iotml_torch.models.lstm import LSTMSpec
from iotml_torch.models.mnist import MNISTClassifier
from iotml_torch.models.transformer import SensorFormer
from iotml_torch.mqtt.bridge import KafkaBridge
from iotml_torch.mqtt.broker import MqttBroker
from iotml_torch.mqtt.eventserver import MqttEventServer
from iotml_torch.mqtt.native_ingest import NativeIngestBridge
from iotml_torch.mqtt.wire import MqttClient
from iotml_torch.obs import ScalarLogger
from iotml_torch.obs import dashboards as obs_dashboards
from iotml_torch.obs import drill as obs_drill
from iotml_torch.obs import federate as obs_federate
from iotml_torch.obs import metrics as obs_metrics
from iotml_torch.obs import profile as obs_profile
from iotml_torch.obs import slo as obs_slo
from iotml_torch.obs import tracing as obs_tracing
from iotml_torch.obs import tsdb as obs_tsdb
from iotml_torch.online import __main__ as online_cli
from iotml_torch.online import drill as online_drill
from iotml_torch.online import detectors as online_detectors
from iotml_torch.online.learner import AdaptationPolicy, OnlineLearner
from iotml_torch.ops import _build, fused_train
from iotml_torch.ops.attention import (FLASH_DESIGNS, attention_reference,
                                       flash_attention,
                                       flash_attention_backward_reference,
                                       flash_attention_bwd,
                                       flash_attention_fwd,
                                       flash_attention_reference,
                                       flash_bwd_dkv, flash_bwd_dq,
                                       flash_bwd_inputs, flash_design,
                                       flash_smem)
from iotml_torch.ops.avro import AvroCodec, needs_resolution
from iotml_torch.ops.flash_parity import (bwd_rounding_flips,
                                          check_rejects_scaled_o,
                                          check_wgmma_forward)
from iotml_torch.ops.framing import (frame_entries, iter_frame_entries,
                                     strip_frame)
from iotml_torch.parallel import distributed as parallel_distributed
from iotml_torch.parallel import mesh as parallel_mesh
from iotml_torch.parallel import multihost_worker
from iotml_torch.parallel import streaming as parallel_streaming
from iotml_torch.parallel.data_parallel import ShardedTrainer
from iotml_torch.parallel.seq_parallel import (loss_and_grads,
                                               make_sp_train_step)
from iotml_torch.serve import fastfmt
from iotml_torch.serve import scorer as scorer_module
from iotml_torch.serve.carhealth import CarHealthDetector
from iotml_torch.serve.live import LiveScorer
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.store import StorePolicy, TierPolicy
from iotml_torch.store import segment as store_segment
from iotml_torch.store.log import store_recovery_truncated
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.group import GroupConsumer, GroupCoordinator
from iotml_torch.stream.kafka_wire import (KafkaWireBroker, KafkaWireServer,
                                          RemoteGroupCoordinator)
from iotml_torch.stream.native_kafka import NativeKafkaBroker
from iotml_torch.stream.producer import (OutputSequence, RawBatchProducer,
                                         raw_produce_records)
from iotml_torch.stream.registry import SchemaRegistry, subject_for_topic
from iotml_torch.stream.registry_server import SchemaRegistryServer
from iotml_torch.streamproc import KsqlServer, SqlEngine
from iotml_torch.streamproc.sql import REFERENCE_PIPELINE_DDL
from iotml_torch.supervise.supervisor import Supervisor
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.live import ContinuousTrainer
from iotml_torch.train.loop import Trainer, TrainState, make_scanned_fit
from iotml_torch.train.optim import Adam
from iotml_torch.twin import CHANGELOG_TOPIC, TwinFeatureStore, TwinService
from iotml_torch.twin.__main__ import main as twin_cli
from iotml_torch.utils import hdf5

#: the JAX suite's own fused-vs-scanned bounds (tests/test_fused_train.py)
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
RESUME_TOL = dict(rtol=1e-4, atol=1e-7)
#: flash forward against its plain version, FMA and split-TF32 designs:
#: f32 is the JAX suite's flash forward bound (tests/test_attention.py:
#: 56-57); bf16 allows for P being rounded at the running max of tiles
#: that differ in size.
#: The ``wgmma`` design is held by ``flash_parity.check_wgmma_forward``
#: (each O row within 1e-2 of its norm; O rtol 2e-2 / atol 1e-3 against
#: the plain version at the kernel's key tile, blocks 64).
ATTN_TOL = {torch.float32: (dict(rtol=2e-5, atol=2e-5),
                            dict(rtol=2e-5, atol=2e-5)),
            torch.bfloat16: (dict(rtol=2e-2, atol=2e-2),
                             dict(rtol=0.0, atol=1e-3))}
#: SensorFormer flash vs plain/dense (tests/test_transformer_sp.py:36-39)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
#: flash backward against its plain version: f32 is the JAX suite's flash
#: grad bound (tests/test_attention.py:70-71); bf16 allows one rounding of
#: each output (2^-7 of the value) after f32 sums in another order (P
#: comes from the LSE, so the tiles change nothing else), and a row moved
#: by one p or ds rounding flip (``flash_parity.bwd_rounding_flips``)
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
#: a training step's loss and parameter grads, kernels vs plain versions
#: or dense attention (tests/test_torch_seq_parallel.py)
TRAIN_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
#: published H100 SXM peaks: fp32 outside the tensor cores, bf16 and TF32
#: dense tensor cores, HBM3; its SMs, and their ex2 rate (16 a clock an SM
#: at 1.98 GHz)
FP32_FLOPS = 67e12
SMS = 132
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES_S = 3.35e12
EX2_PER_S = SMS * 16 * 1.98e9
#: a float32 product on the tensor cores is three tf32 products (split
#: TF32: hi·hi + hi·lo + lo·hi), so the f32 bound counts 3 × its flops at
#: the TF32 peak
TF32_TERMS = 3


#: (phase, seconds since the module loaded) at each phase line: where the
#: whole run's time goes, printed by ``main`` before the kernels line
PHASE_ENDS: list = []
_T_LOADED = time.perf_counter()


def emit(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        PHASE_ENDS.append((obj["phase"],
                           round(time.perf_counter() - _T_LOADED, 1)))
    print(json.dumps(obj), flush=True)


def check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float) -> float:
    """Raise unless |got - want| <= atol + rtol·|want| everywhere; return
    the largest absolute difference."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} outside rtol {rtol} "
            f"atol {atol}; max abs diff {float(diff.max())}")
    return float(diff.max())


def fresh_state(spec, device, seed=0) -> TrainState:
    model = spec.build(device, torch.Generator().manual_seed(seed))
    return TrainState.create(model, Adam())


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi.stdout.strip().splitlines()[0],
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def _fit_kernel(mangled: str):
    """A fit kernel's name in the ptxas log: ``elements`` or a rows
    instantiation (``rows F=18 E=14 H=7``, ...)."""
    rows = re.search(r"fused_fit_rows_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                     mangled)
    if rows:
        return f"rows F={rows.group(1)} E={rows.group(2)} H={rows.group(3)}"
    return "elements" if "fused_fit_kernel" in mangled else None


def _flash_kernel(mangled: str):
    """A flash kernel instantiation's name in the ptxas log: the FMA
    ``flash_fwd_kernel``, ``flash_bwd_dkv_kernel`` and
    ``flash_bwd_dq_kernel`` by dtype and head dim, the tensor-core
    ``flash_{fwd,bwd_dkv,bwd_dq}_wgmma_kernel`` and the split-TF32
    ``flash_{fwd,bwd_dkv,bwd_dq}_mma_kernel``."""
    found = re.match(r"\S*(flash_\w+)_kernelI(f|13__nv_bfloat16)Li(\d+)ELb"
                     r"([01])E", mangled)
    wgmma = re.match(r"\S*(flash_\w+)_wgmma_kernelILb([01])E", mangled)
    mma = re.match(r"\S*(flash_\w+)_mma_kernelILi(\d+)ELb([01])E", mangled)
    if mma:
        return (f"{mma.group(1)} f32 D={mma.group(2)} "
                f"{'causal' if mma.group(3) == '1' else 'full'} mma_tf32x3")
    if found:
        dtype = "f32" if found.group(2) == "f" else "bf16"
        return (f"{found.group(1)} {dtype} D={found.group(3)} "
                f"{'causal' if found.group(4) == '1' else 'full'}")
    if wgmma:
        return (f"{wgmma.group(1)} bf16 D=128 "
                f"{'causal' if wgmma.group(2) == '1' else 'full'} wgmma")
    return None


def phase_build() -> None:
    """Build the three CUDA sources and the native stream engine
    together, one compiler each."""
    def timed(name):
        t0 = time.perf_counter()
        built = not _build.library_path(name).exists()
        log = _build.build_log(name)
        return name, log, built, time.perf_counter() - t0

    def engine():
        t0 = time.perf_counter()
        path = native.library_path()
        fresh = not path.exists()
        native.load()  # built and loaded here, outside every timed path
        return {"library": path.name, "built": fresh,
                "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    names = ("fused_train", "flash_attention", "flash_attention_bwd")
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        native_build = pool.submit(engine)
        built = list(pool.map(timed, names))
        native_engine = native_build.result()
    wall = time.perf_counter() - t0
    sources = {}
    for name, log, fresh, seconds in built:
        sources[name] = {"seconds": seconds, "built": fresh}
        if name.startswith("flash_attention"):
            sources[name]["ptxas"] = ptxas = _build.ptxas_kernels(
                log, _flash_kernel)
            spilled = [k for k, v in ptxas.items()
                       if v.get("spill_stores") or v.get("spill_loads")]
            split = sorted(k for k in ptxas if k.endswith("mma_tf32x3"))
            kinds = {"flash_attention": ("fwd",),
                     "flash_attention_bwd": ("bwd_dkv", "bwd_dq")}[name]
            if split != sorted(
                    f"flash_{kind} f32 D={d} {entry} mma_tf32x3"
                    for kind in kinds for d in (8, 16)
                    for entry in ("causal", "full")):
                raise AssertionError(f"split-TF32 kernels in the ptxas "
                                     f"log of {name}: {split}")
        else:
            sources[name]["ptxas"] = ptxas = _build.ptxas_kernels(
                log, _fit_kernel)
            if sorted(ptxas) != ["elements", "rows F=18 E=14 H=7",
                                 "rows F=30 E=14 H=7"]:
                raise AssertionError(f"fit kernels in the ptxas log: "
                                     f"{sorted(ptxas)}")
            spilled = [k for k, v in ptxas.items() if k.startswith("rows")
                       and (v.get("spill_stores") or v.get("spill_loads"))]
        if spilled:
            raise AssertionError(f"ptxas spills in {spilled}")
    smem = {f"F={spec.input_dim} {design}": fused_train.smem(
        spec.build("cuda").state_dict(), 100, "cuda", design)
        for spec in (CAR_AUTOENCODER, CREDITCARD_AUTOENCODER)
        for design in fused_train.DESIGNS}
    flash_smem_bytes = {f"{kind} {str(dtype)[6:]} D={d}": flash_smem(
        kind, d, dtype) for kind in ("fwd", "dkv", "dq")
        for dtype in FLASH_DTYPES for d in (8, 16, 128)}
    emit({"phase": "build", "seconds": wall, "sources": sources,
          "native_engine": native_engine,
          "smem_need_optin_bytes_at_B100": smem,
          "flash_smem_bytes_per_block": flash_smem_bytes,
          "fit_design": check_fit_designs(),
          "flash_design": check_designs(),
          **check_tensor_core_sass()})


FLASH_DTYPES = (torch.float32, torch.bfloat16)
FLASH_SOURCES = ("flash_attention", "flash_attention_bwd")


#: (B, F, E, H) over which the fit kernel's two design rules must agree
FIT_DESIGN_GRID = [(B, F, E, H)
                   for B in (1, 31, 100, 128, 129, 200, 256, 257, 300)
                   for F, E, H in ((18, 14, 7), (30, 14, 7), (18, 16, 7),
                                   (18, 14, 8), (12, 14, 7))]


def check_fit_designs() -> dict:
    """The fit kernel's design over ``FIT_DESIGN_GRID``: the library's
    ``iotml_fused_fit_design`` must be ``fit_design``'s (which shapes
    that is, the CPU tests hold).  Returns the count of each."""
    lib = fused_train._library()
    counts = dict.fromkeys(fused_train.DESIGNS, 0)
    for B, F, E, H in FIT_DESIGN_GRID:
        built = fused_train.DESIGNS[lib.iotml_fused_fit_design(B, F, E, H)]
        said = fused_train.fit_design(B, F, E, H)
        if built != said:
            raise AssertionError(f"fit design at B={B} F={F} E={E} H={H}: "
                                 f"library {built}, fit_design {said}")
        counts[said] += 1
    return counts


def check_designs() -> dict:
    """The design of each dtype and head dim in both directions: what each
    built library dispatches to (``iotml_flash_fwd_design``,
    ``iotml_flash_bwd_design``, codes named by ``FLASH_DESIGNS``) must be
    what ``flash_design`` says (which designs those are, the CPU tests
    hold); each direction takes all three designs."""
    libs = {"forward": _build.load("flash_attention").iotml_flash_fwd_design,
            "backward":
            _build.load("flash_attention_bwd").iotml_flash_bwd_design}
    designs = {}
    for code, dtype in enumerate(FLASH_DTYPES):
        for d in (8, 16, 128):
            for direction, lib_design in libs.items():
                built = FLASH_DESIGNS[lib_design(d, code)]
                said = flash_design(dtype, d, direction)
                if built != said:
                    raise AssertionError(
                        f"{direction} {dtype} D={d}: library {built}, "
                        f"flash_design {said}")
                designs[f"{direction} {str(dtype)[6:]} D={d}"] = said
    for direction in libs:
        if set(v for k, v in designs.items() if k.startswith(direction)) \
                != set(FLASH_DESIGNS):
            raise AssertionError(f"the {direction} does not take all three "
                                 f"designs: {designs}")
    return designs


def check_tensor_core_sass() -> dict:
    """Tensor-core instructions in the SASS (``cuobjdump -sass``): HGMMA in
    each ``wgmma`` instantiation, forward and backward (six), and
    HMMA…TF32 in each split-TF32 instantiation (twelve: the forward, dK/dV
    and dQ, D=8 and 16, causal and full); raises unless each has some."""
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    hgmma, hmma = {}, {}
    for name in FLASH_SOURCES:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        for part in sass.split("Function : ")[1:]:
            head = part.splitlines()[0]
            found = re.search(r"\S*(flash_\w+)_wgmma_kernelILb([01])E", head)
            split = re.search(r"\S*(flash_\w+)_mma_kernelILi(\d+)ELb([01])E",
                              head)
            if found:
                entry = "causal" if found.group(2) == "1" else "full"
                hgmma[f"{found.group(1)} {entry}"] = part.count("HGMMA")
            elif split:
                entry = "causal" if split.group(3) == "1" else "full"
                hmma[f"{split.group(1)} D={split.group(2)} {entry}"] = len(
                    re.findall(r"HMMA\S*TF32", part))
    if len(hgmma) != 6 or not all(hgmma.values()):
        raise AssertionError(f"HGMMA in the tensor-core kernels: {hgmma}")
    if len(hmma) != 12 or not all(hmma.values()):
        raise AssertionError(f"HMMA.TF32 in the split-TF32 kernels: {hmma}")
    return {"hgmma_per_wgmma_kernel": hgmma,
            "hmma_tf32_per_mma_kernel": hmma}


def check_fit(tag: str, kernel_out, plain_out, steps: int,
              parts=("params", "mu", "nu")) -> float:
    """Hold a kernel fit against the plain version's on the same inputs:
    every epoch's loss and accuracy at METRIC_TOL, the final ``parts``
    (params, mu and nu) at STATE_TOL, and the step count.  Returns the
    largest absolute difference."""
    (k_state, k_loss, k_acc), (p_state, p_loss, p_acc) = kernel_out, plain_out
    err = max(check_close(f"{tag} losses", k_loss, p_loss, **METRIC_TOL),
              check_close(f"{tag} accs", k_acc, p_acc, **METRIC_TOL))
    for name, k_tree, p_tree in (
            ("params", k_state.params, p_state.params),
            ("mu", k_state.opt_state.mu, p_state.opt_state.mu),
            ("nu", k_state.opt_state.nu, p_state.opt_state.nu)):
        if name not in parts:
            continue
        for key in PARAM_NAMES:
            err = max(err, check_close(f"{tag} {name} {key}", k_tree[key],
                                       p_tree[key], **STATE_TOL))
    if k_state.step != steps or k_state.opt_state.count != steps:
        raise AssertionError(f"{tag}: step {k_state.step}, count "
                             f"{k_state.opt_state.count}, not {steps}")
    return err


def kernel_case(spec, fractional: bool, seed: int, B: int = 100) -> float:
    """Kernel vs plain on one input, in the design ``fit_design`` picks
    (each launch must go through it); returns the largest abs
    difference."""
    F = spec.input_dim
    S, epochs = 6, 4
    design = fused_train.fit_design(B, F, spec.encoding_dim,
                                    spec.hidden_dim)
    by_design = dict(fused_train.fused_fit.launches_by_design)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (S, B, F)).astype(np.float32)
    xs[:, :, ::5] = 0.0  # zeroed columns, as the parity normalizer makes
    masks = np.ones((S, B), np.float32)
    masks[-1, 63:] = 0.0  # ragged last batch
    xs[-1, 63:] = 0.0
    if fractional:
        masks *= rng.uniform(0.25, 1.0, masks.shape).astype(np.float32)
    xs_d = torch.from_numpy(xs).cuda()
    masks_d = torch.from_numpy(masks).cuda()
    state = fresh_state(spec, "cuda", seed)

    k_state, k_loss, k_acc = kernel_out = fused_train.fused_fit(
        state, xs_d, masks_d, epochs)
    torch.cuda.synchronize()
    plain_out = fused_train.fused_fit_reference(state, xs_d, masks_d, epochs)
    tag = f"{design} B={B} F={F} fractional={fractional}"
    err = check_fit(tag, kernel_out, plain_out, S * epochs)

    # bit-for-bit repeat
    r_state, r_loss, r_acc = fused_train.fused_fit(state, xs_d, masks_d, epochs)
    same = torch.equal(r_loss, k_loss) and torch.equal(r_acc, k_acc) and all(
        torch.equal(r_state.params[k], k_state.params[k]) for k in PARAM_NAMES)
    if not same:
        raise AssertionError(f"{tag}: two runs of the kernel differ")

    # resume: 2 + 2 epochs == 4
    a_state, a_loss, _ = fused_train.fused_fit(state, xs_d, masks_d, 2)
    b_state, b_loss, _ = fused_train.fused_fit(a_state, xs_d, masks_d, 2)
    check_close(f"{tag} resume losses", torch.cat([a_loss, b_loss]), k_loss,
                **RESUME_TOL)
    check_close(f"{tag} resume encoder0.weight",
                b_state.params["encoder0.weight"],
                k_state.params["encoder0.weight"], rtol=1e-3, atol=1e-6)
    torch.cuda.synchronize()
    launched = {k: v - by_design[k] for k, v in
                fused_train.fused_fit.launches_by_design.items()}
    if launched != {**dict.fromkeys(by_design, 0), design: 4}:
        raise AssertionError(f"{tag}: launches by design {launched}")
    return err


def phase_kernel() -> float:
    errs = {}
    for spec in (CAR_AUTOENCODER, CREDITCARD_AUTOENCODER):
        for fractional in (False, True):
            errs[f"rows F={spec.input_dim} fractional={fractional}"] = \
                kernel_case(spec, fractional,
                            seed=spec.input_dim + fractional)
    errs["rows B=256 F=30 fractional=True"] = kernel_case(
        CREDITCARD_AUTOENCODER, True, seed=256, B=256)
    errs["elements B=300 F=18 fractional=True"] = kernel_case(
        CAR_AUTOENCODER, True, seed=300, B=300)
    emit({"phase": "kernel", "kernel": "fused_fit", "cases": len(errs),
          "max_abs_err": errs, "metric_tol": METRIC_TOL,
          "state_tol": STATE_TOL, "resume_tol": RESUME_TOL,
          "bit_repeat": True})
    return max(errs.values())


class Call(NamedTuple):
    """One recorded call: its arguments, result and wall seconds (the
    wrapped functions end in a device-to-host copy, so the seconds hold
    their device work)."""

    args: tuple
    kw: dict
    result: object
    seconds: float


@contextlib.contextmanager
def _recording(owner, name: str):
    """Wrap ``owner.name`` (a module's function or a class's method) so
    each call is recorded as a ``Call``."""
    real = getattr(owner, name)
    calls = []

    def spy(*args, **kw):
        t0 = time.perf_counter()
        result = real(*args, **kw)
        calls.append(Call(args, kw, result, time.perf_counter() - t0))
        return result

    setattr(owner, name, spy)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def _check_engine_formatted(formats, n_rows: int, formatted: int,
                            where: str) -> np.ndarray:
    """The rows the scorer formatted, after checking that the engine
    formatted every one of them that its fast path takes (the plain
    version's ``fast_rows`` rule), and numpy only the others."""
    rows = np.concatenate([call.args[0] for call in formats])
    want = int(fastfmt.fast_rows(rows).sum())
    if rows.shape[0] != n_rows or formatted != want or want == 0:
        raise AssertionError(f"{where}: the native engine formatted "
                             f"{formatted} of {rows.shape[0]} payload rows; "
                             f"its fast path takes {want} of them")
    return rows


def phase_main_path(card: str) -> dict:
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    source = RowSource.from_fleet(gen, n_ticks=300)
    train_batches = SensorBatches(source, batch_size=100, take=100,
                                  only_normal=True)
    trainer = Trainer(CAR_AUTOENCODER)  # device=None: the card
    reset_fit_launches()
    t0 = time.perf_counter()
    hist = trainer.fit_compiled(train_batches, epochs=20)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = hist["loss"]
    if len(losses) != 20 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not converge: {losses}")
    if hist["records"][0] != 10_000:
        raise AssertionError(f"trained on {hist['records'][0]} rows")

    score_batches = SensorBatches(source, batch_size=100, skip=100, take=100,
                                  keep_labels=True)
    out = OutputSequence()
    scorer = StreamScorer(CAR_AUTOENCODER, trainer.state.params,
                          score_batches, out, threshold=5.0)
    native.reset_stats()
    with _recording(scorer_module, "format_rows") as formats:
        t0 = time.perf_counter()
        n = scorer.score_available()
        score_s = time.perf_counter() - t0
    formatted = native.stats["format_rows"]
    _check_engine_formatted(formats, n, formatted, "main_path")
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if launches != 1 or by_design["rows"] != 1:
        raise AssertionError(f"the main path launched the fit kernel "
                             f"{launches}x ({by_design}), not once through "
                             f"the rows design")
    if n != 10_000 or len(out.published) != 10_000:
        raise AssertionError(f"scored {n} rows, published {len(out.published)}")
    if [i for i, _ in out.published] != list(range(10_000)):
        raise AssertionError("predictions not in index order")
    if not all(msg.startswith(b"[") for _, msg in out.published):
        raise AssertionError("a payload does not start with '['")

    # the payloads against the trained weights recomputed on the CPU
    check = SensorBatches(source, batch_size=100, skip=100, take=1)
    x = torch.from_numpy(next(iter(check)).x)
    cpu_model = CAR_AUTOENCODER.build("cpu")
    cpu_params = {k: v.cpu() for k, v in trainer.state.params.items()}
    with torch.no_grad():
        want = reconstruction_error(cpu_model, cpu_params, x).numpy()
    got = np.array([float(msg.decode().rsplit("|", 1)[1])
                    for _, msg in out.published[:100]])
    pred0 = np.array(out.published[0][1].decode().split("|")[0]
                     .strip("[]").split(), np.float64)
    if pred0.shape != (18,) or not np.isfinite(pred0).all() \
            or not np.allclose(got, want, rtol=0, atol=2e-6):
        raise AssertionError(f"payload errors disagree with a CPU recompute: "
                             f"max {np.abs(got - want).max()}")
    info = {"phase": "main_path", "card": card, "fit_seconds": fit_s,
            "host_pipeline_s": hist["host_pipeline_s"],
            "device_compute_s": hist["device_compute_s"],
            "loss_first": losses[0], "loss_last": losses[-1],
            "kernel_launches": launches,
            "kernel_launches_by_design": by_design,
            "rows_trained_per_epoch": 10_000,
            "rows_scored": n, "score_seconds": score_s,
            "score_rows_per_s": n / score_s,
            "score_host_pipeline_s": scorer.seconds["host_pipeline"],
            "score_device_compute_s": scorer.seconds["device_compute"],
            "score_format_s": native.stats["format_s"],
            "native_format_rows": formatted,
            "quality": scorer.quality}
    emit(info)
    return {"launches": launches, "launches_by_design": by_design,
            "batches": train_batches, "source": source}


CLI_TOPIC, CLI_GROUP = "SENSOR_DATA_S_AVRO", "cardata-autoencoder"
#: the CLI's payloads against a CPU recompute from the restored params:
#: the first 100 rows at main_path's bound, every row at a bound that
#: still tells each row from its neighbours (index order)
CLI_TOL_FIRST = dict(rtol=0.0, atol=2e-6)
CLI_TOL_ALL = dict(rtol=0.0, atol=1e-5)


def _run_cli(mode: str, root: str, servers: str = "emulator:30000",
             flags=(), model: str = "m1") -> dict:
    """One ``cardata.main`` call on the card: its stdout, stats line,
    seconds and the broker it made."""
    argv = [servers, CLI_TOPIC, "0", "model-predictions", mode, model, root,
            *flags]
    out = io.StringIO()
    with _recording(cli_app, "_broker_for") as brokers, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = cardata.main(argv)  # device=None: the card
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"cardata {mode} returned {rc}:\n{text}")
    stats = [line for line in text.splitlines()
             if line.startswith("stats: ")]
    return {"seconds": seconds, "broker": brokers[0].result,
            "stats": json.loads(stats[-1][len("stats: "):])}


def phase_cli_path(card: str, root: str) -> dict:
    """cardata train then predict; the checkpoint stays in ``root`` for
    serve_path."""
    reset_fit_launches()
    native.reset_stats()
    with _recording(cli_app, "Trainer") as trainers:
        train = _run_cli("train", root)
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    train_native = dict(native.stats)
    if launches != 1 or by_design["rows"] != 1:
        raise AssertionError(f"cardata train launched the fit kernel "
                             f"{launches}x ({by_design}), not once through "
                             f"the rows design")
    losses = train["stats"]["loss"]
    if len(losses) != 20 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"cardata train did not converge: {losses}")
    if train["stats"]["records"] != 10_000 or \
            train_native["decode_rows"] < 10_000:
        raise AssertionError(f"cardata train: {train['stats']}, native "
                             f"{train_native}")

    # the stored checkpoint is the trained state, bit for bit, and carries
    # the cursor the group committed after it was stored
    state = trainers[0].result.state
    ckpt = CheckpointManager.load_dir(ArtifactStore(root).download_tree(
        "m1", str(Path(root) / "restored")))
    committed = train["broker"].committed(CLI_GROUP, CLI_TOPIC, 0)
    for tree, want in (("params", state.params), ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        got = ckpt["params"] if tree == "params" \
            else getattr(ckpt["opt_state"], tree)
        for k in PARAM_NAMES:
            if not torch.equal(got[k], want[k].cpu()):
                raise AssertionError(f"checkpoint {tree}/{k} differs from "
                                     f"the trained state")
    if (ckpt["step"], ckpt["opt_state"].count) != (2000, 2000) or \
            ckpt["cursors"] != [(CLI_TOPIC, 0, committed)]:
        raise AssertionError(f"checkpoint step/count/cursors "
                             f"{ckpt['step']}, {ckpt['opt_state'].count}, "
                             f"{ckpt['cursors']}; committed {committed}")

    native.reset_stats()
    with _recording(scorer_module, "format_rows") as formats, \
            _recording(native.NativeCodec, "decode_batch") as decodes:
        predict = _run_cli("predict", root)
    predict_native = dict(native.stats)
    broker = predict["broker"]
    end = broker.end_offset("model-predictions", 0)
    payloads = [m.value.decode()
                for m in broker.fetch("model-predictions", 0, 0, end + 1)]
    if end != 10_000 or len(payloads) != 10_000 \
            or predict["stats"]["rows"] != 10_000:
        raise AssertionError(f"model-predictions ends at {end} "
                             f"({len(payloads)} payloads)")
    # every payload is the engine's string for a scored row, and that
    # string is np.array2string of the row, byte for byte
    rows = _check_engine_formatted(formats, 10_000,
                                   predict_native["format_rows"], "cli_path")
    engine_msgs = [m for call in formats for m in call.result]
    if engine_msgs != payloads:
        raise AssertionError("the topic's payloads are not the formatter's "
                             "strings in order")
    mismatched = sum(a != np.array2string(r)
                     for a, r in zip(engine_msgs, rows))
    if mismatched:
        raise AssertionError(f"{mismatched} payloads differ from "
                             f"np.array2string")
    if predict_native["decode_rows"] != 20_000:
        raise AssertionError(f"native engine on predict: {predict_native}")
    # what the engine decoded on predict, exactly the pure codec's columns
    # for the same messages
    pure = AvroCodec(KSQL_CAR_SCHEMA)
    for (codec, msgs), kw, (num, lab), _ in decodes:
        if kw.get("strip") != 5:
            raise AssertionError(f"predict decoded with {kw}, not strip=5")
        cols = pure.decode_batch([strip_frame(m) for m in msgs])
        label = [f.name for f in codec.schema.fields
                 if f.avro_type == "string"].index(
                     KSQL_CAR_SCHEMA.label_field)
        if not np.array_equal(num, pure.sensor_matrix(cols)) or \
                [v.decode() for v in lab[:, label]] != \
                list(cols[KSQL_CAR_SCHEMA.label_field]):
            raise AssertionError("the native decode of predict's messages "
                                 "differs from the pure codec's")
    decoded = sum(len(call.args[1]) for call in decodes)

    # the payloads against the restored params recomputed on the CPU
    check = SensorBatches(
        StreamConsumer(predict["broker"], [f"{CLI_TOPIC}:0:0"]),
        batch_size=100, skip=100, take=100)
    x = torch.from_numpy(np.concatenate([b.x for b in check]))
    with torch.no_grad():
        want = torch.func.functional_call(
            CAR_AUTOENCODER.build("cpu"), ckpt["params"], (x,)).numpy()
    got = np.array([np.array(p.strip("[]").split(), np.float64)
                    for p in payloads])
    err_first = float(np.abs(got[:100] - want[:100]).max())
    err_all = float(np.abs(got - want).max())
    if got.shape != (10_000, 18) or not np.isfinite(got).all() \
            or not np.allclose(got[:100], want[:100], **CLI_TOL_FIRST) \
            or not np.allclose(got, want, **CLI_TOL_ALL):
        raise AssertionError(f"payloads disagree with a CPU recompute: "
                             f"first 100 max {err_first}, all max {err_all}")

    # format_rows against numpy and the plain version on these rows
    def timed(fn):
        t0 = time.perf_counter()
        out = fn(rows)
        return time.perf_counter() - t0, out

    fmt_s, fmt_out = timed(fastfmt.format_rows)
    np_s, np_out = timed(lambda r: [np.array2string(v) for v in r])
    plain_s, plain_out = timed(fastfmt.format_rows_plain)
    if not fmt_out == np_out == plain_out:
        raise AssertionError("format_rows, its plain version and numpy "
                             "disagree")
    info = {"phase": "cli_path", "card": card,
            "train_seconds": train["seconds"],
            "predict_seconds": predict["seconds"],
            "fit_seconds": train["stats"]["fit_seconds"],
            "fit_host_pipeline_s": train["stats"]["host_pipeline_s"],
            "fit_device_compute_s": train["stats"]["device_compute_s"],
            "loss_first": losses[0], "loss_last": losses[-1],
            "kernel_launches": launches,
            "kernel_launches_by_design": by_design,
            "train_decode_rows": train_native["decode_rows"],
            "train_decode_s": train_native["decode_s"],
            "publish_encode_rows": train_native["encode_rows"],
            "publish_encode_s": train_native["encode_s"],
            "committed_offset": committed,
            "rows_scored": predict["stats"]["rows"],
            "score_seconds": predict["stats"]["score_seconds"],
            "score_rows_per_s": predict["stats"]["rows"]
            / predict["stats"]["score_seconds"],
            "score_host_pipeline_s": predict["stats"]["host_pipeline_s"],
            "score_device_compute_s": predict["stats"]["device_compute_s"],
            "predict_decode_rows": predict_native["decode_rows"],
            "predict_decode_rows_held_to_pure_codec": decoded,
            "predict_decode_s": predict_native["decode_s"],
            "format_rows_native": predict_native["format_rows"],
            "format_s": predict_native["format_s"],
            "max_abs_err_first_100": err_first,
            "max_abs_err_all": err_all,
            "format_10k_ms": {"format_rows": fmt_s * 1e3,
                              "np_array2string": np_s * 1e3,
                              "format_rows_plain": plain_s * 1e3}}
    emit(info)
    return {"launches": launches, "launches_by_design": by_design,
            "payloads": payloads}


SERVE_TOPIC = "SENSOR_DATA_S_AVRO"


@contextlib.contextmanager
def _shared_broker(broker):
    """Every ``_broker_for`` call in the block hands back ``broker``: the
    emulator is made anew per call, and a resume needs one log."""
    real = cli_app._broker_for
    cli_app._broker_for = lambda *a: broker
    try:
        yield
    finally:
        cli_app._broker_for = real


def _run_serve(argv, max_rounds: int) -> dict:
    """One ``serve.main`` call on the card: seconds and its stats line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = serve_cli.main(argv, max_rounds=max_rounds)  # the card
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"serve returned {rc}:\n{text}")
    stats = [line for line in text.splitlines()
             if line.startswith("stats: ")]
    return {"seconds": seconds,
            "stats": json.loads(stats[-1][len("stats: "):])}


def _payload_parts(payloads):
    """(rows [n, 18], verdicts, errors) of ``row|verdict|err`` payloads."""
    rows, verdicts, errs = [], [], []
    for p in payloads:
        row, verdict, err = p.split("|")
        rows.append(np.array(row.strip("[]").split(), np.float64))
        verdicts.append(verdict)
        errs.append(float(err))
    return np.array(rows), verdicts, np.array(errs)


def _recompute(broker, params, topic=SERVE_TOPIC, start=0, n=None):
    """The CPU forward of the topic's partition-0 rows from ``start``."""
    batches = SensorBatches(StreamConsumer(broker, [f"{topic}:0:{start}"]),
                            batch_size=100)
    x = torch.from_numpy(np.concatenate([b.x[:b.n_valid] for b in batches]))
    with torch.no_grad():
        return torch.func.functional_call(CAR_AUTOENCODER.build("cpu"),
                                          params, (x,)).numpy(), x.numpy()


def _check_serve_payloads(payloads, want, x, threshold, where) -> tuple:
    rows, verdicts, errs = _payload_parts(payloads)
    if rows.shape != want.shape or not np.isfinite(rows).all():
        raise AssertionError(f"{where}: payload rows {rows.shape}, want "
                             f"{want.shape}")
    err_first = float(np.abs(rows[:100] - want[:100]).max())
    err_all = float(np.abs(rows - want).max())
    if not np.allclose(rows[:100], want[:100], **CLI_TOL_FIRST) \
            or not np.allclose(rows, want, **CLI_TOL_ALL):
        raise AssertionError(f"{where}: payloads disagree with a CPU "
                             f"recompute: first 100 max {err_first}, all "
                             f"max {err_all}")
    want_err = np.square(want - x).mean(axis=1)
    # a printed error within a printed digit of the threshold may sit on
    # either side of it
    flipped = [v != ("anomaly" if e > threshold else "normal")
               for v, e in zip(verdicts, errs) if abs(e - threshold) > 1e-6]
    if any(flipped) or set(verdicts) - {"normal", "anomaly"} or \
            not np.allclose(errs, want_err, rtol=0, atol=2e-6):
        raise AssertionError(f"{where}: verdict suffixes disagree with the "
                             f"errors ({sum(flipped)} flipped, max err "
                             f"diff {np.abs(errs - want_err).max()})")
    return err_first, err_all, verdicts.count("anomaly")


def phase_serve_path(card: str, root: str) -> dict:
    reset_fit_launches()
    reset_launches()
    ckpt = CheckpointManager.load_dir(ArtifactStore(root).download_tree(
        "m1", str(Path(root) / "serve_restored")))
    broker = cli_app._broker_for("emulator:30000", SERVE_TOPIC)
    argv = ["emulator:30000", SERVE_TOPIC, "committed", "model-predictions",
            "m1", root, "--serve.poll_interval_s=0", "--serve.threshold=5"]
    native.reset_stats()
    with _shared_broker(broker):
        first = _run_serve(argv, max_rounds=2)
        end = broker.end_offset("model-predictions", 0)
        committed = broker.committed(serve_cli.GROUP, SERVE_TOPIC, 0)
        if (end, committed, first["stats"]["rows"]) != (30_000,) * 3:
            raise AssertionError(f"committed serve: {end} payloads, cursor "
                                 f"{committed}, stats {first['stats']}")
        payloads = [m.value.decode() for m in
                    broker.fetch("model-predictions", 0, 0, end)]
        want, x = _recompute(broker, ckpt["params"])
        err_first, err_all, anomalies = _check_serve_payloads(
            payloads, want, x, 5.0, "serve committed")
        values = [m.value for m in broker.fetch(SERVE_TOPIC, 0, 0, 30_000)]
        t0 = time.perf_counter()
        evolved = any(needs_resolution(v) for v in values)
        resolution_s = time.perf_counter() - t0
        if evolved:
            raise AssertionError("a v1 record took the resolving decode")
        # 500 more records: the resumed call scores exactly those
        FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01)) \
            .publish(broker, SERVE_TOPIC, n_ticks=5)
        resume = _run_serve(argv, max_rounds=2)
        end = broker.end_offset("model-predictions", 0)
        committed = broker.committed(serve_cli.GROUP, SERVE_TOPIC, 0)
        if (end, committed, resume["stats"]["rows"]) != \
                (30_500, 30_500, 500):
            raise AssertionError(f"resumed serve: {end} payloads, cursor "
                                 f"{committed}, stats {resume['stats']}")
        want, x = _recompute(broker, ckpt["params"], start=30_000)
        _check_serve_payloads([m.value.decode() for m in broker.fetch(
            "model-predictions", 0, 30_000, 500)], want, x, 5.0,
            "serve resume")
    cold = _cold_process_serve(root)
    drill = _group_drill(ckpt["params"])
    launches = {"fused_fit": fused_train.fused_fit.launches,
                **flash_attention.launches}
    if any(launches.values()):
        raise AssertionError(f"the serve path launched kernels: {launches}")
    st = first["stats"]
    info = {"phase": "serve_path", "card": card,
            "rows_scored": st["rows"], "rounds": st["rounds"],
            "rewinds": st["rewinds"], "anomalies": anomalies,
            "committed_offset": 30_000,
            "serve_seconds": st["serve_seconds"],
            "first_forward_s": st["first_forward_s"],
            "drain_rows_per_s": st["rows"] / st["serve_seconds"],
            "drain_rows_per_s_after_first_forward":
                st["rows"] / (st["serve_seconds"] - st["first_forward_s"]),
            "host_pipeline_s": st["host_pipeline_s"],
            "device_compute_s": st["device_compute_s"],
            "write_back_s": st["write_back_s"],
            "decode_rows": st["decode_rows"], "decode_s": st["decode_s"],
            "format_rows_native": st["format_rows"],
            "format_s": st["format_s"],
            "call_seconds": first["seconds"],
            "resume_rows": resume["stats"]["rows"],
            "resume_seconds": resume["stats"]["serve_seconds"],
            "resume_first_forward_s": resume["stats"]["first_forward_s"],
            "resolution_check_s_30k": resolution_s,
            "resolution_check_share_of_drain":
                resolution_s / st["serve_seconds"],
            "max_abs_err_first_100": err_first,
            "max_abs_err_all": err_all,
            "cold_process": cold, "group_drill": drill,
            "kernel_launches": launches}
    emit(info)
    return {"launches": launches}


def _cold_process_serve(root: str) -> dict:
    """The same job in a process of its own, as the deployment starts it:
    its first forward is the cold one."""
    code = ("import sys; from iotml_torch.cli import serve; sys.exit("
            f"serve.main(['emulator:30000', '{SERVE_TOPIC}', '0', "
            f"'model-predictions', 'm1', {root!r}, "
            "'--serve.poll_interval_s=0', '--serve.threshold=5'], "
            "max_rounds=2))")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(Path(__file__)
                                                         .resolve().parent))
    seconds = time.perf_counter() - t0
    stats = [line for line in run.stdout.splitlines()
             if line.startswith("stats: ")]
    if run.returncode != 0 or not stats:
        raise AssertionError(f"serve in a second process returned "
                             f"{run.returncode}:\n{run.stdout}\n{run.stderr}")
    st = json.loads(stats[-1][len("stats: "):])
    if st["rows"] != 30_000:
        raise AssertionError(f"serve in a second process: {st}")
    return {"process_seconds": seconds, "rows": st["rows"],
            "serve_seconds": st["serve_seconds"],
            "first_forward_s": st["first_forward_s"],
            "host_pipeline_s": st["host_pipeline_s"],
            "device_compute_s": st["device_compute_s"],
            "write_back_s": st["write_back_s"],
            "format_s": st["format_s"],
            "drain_rows_per_s": st["rows"] / st["serve_seconds"]}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _member(coord, broker, params, member_id):
    """A group member under a card scorer; its consumer records every
    delivered (partition, offset) in order."""
    consumer = GroupConsumer(coord, [SERVE_TOPIC], member_id=member_id)
    delivered = []
    poll = consumer.poll

    def recording_poll(max_messages=1024):
        msgs = poll(max_messages)
        delivered.extend((m.partition, m.offset) for m in msgs)
        return msgs

    consumer.poll = recording_poll
    out = OutputSequence()
    scorer = StreamScorer(CAR_AUTOENCODER, params,
                          SensorBatches(consumer, batch_size=100), out,
                          threshold=5.0)  # device=None: the card
    return consumer, scorer, out, delivered


def _group_drill(params) -> dict:
    broker = Broker()
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    gen.publish(broker, SERVE_TOPIC, n_ticks=150, partitions=10)
    clock = FakeClock()
    coord = GroupCoordinator(broker, serve_cli.GROUP, session_timeout_s=5.0,
                             clock=clock)
    ca, sa, out_a, got_a = _member(coord, broker, params, "serve-a")
    cb, sb, out_b, got_b = _member(coord, broker, params, "serve-b")
    t0 = time.perf_counter()
    first_half = sa.score_available() + sb.score_available()
    gen.publish(broker, SERVE_TOPIC, n_ticks=150, partitions=10)
    # b drains its share of the second half and crashes before its commit
    before_crash = len(got_b)
    real_commit = cb.commit
    cb.commit = lambda: False
    crashed_rows = sb.score_available()
    cb.commit = real_commit
    uncommitted = set(got_b[before_crash:])
    clock.t += 6.0  # past the session timeout: b is expired at a's poll
    survivor_rows = sa.score_available()
    drill_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ends = {p: broker.end_offset(SERVE_TOPIC, p) for p in range(10)}
    total = sum(ends.values())
    committed = {p: broker.committed(serve_cli.GROUP, SERVE_TOPIC, p)
                 for p in range(10)}
    every = {(p, o) for p, end in ends.items() for o in range(end)}
    counts = {}
    for tp in got_a + got_b:
        counts[tp] = counts.get(tp, 0) + 1
    dupes = {tp for tp, n in counts.items() if n > 1}
    if total != 30_000 or set(counts) != every or committed != ends \
            or not dupes <= uncommitted or not uncommitted \
            or ca.assignment != [(SERVE_TOPIC, p) for p in range(10)] \
            or ca.rebalances < 2:
        raise AssertionError(
            f"group drill: {total} records, {len(set(counts))} scored, "
            f"committed {committed} vs ends {ends}, {len(dupes)} duplicates "
            f"({len(dupes - uncommitted)} outside the crashed drain of "
            f"{len(uncommitted)}), survivor owns {ca.assignment} after "
            f"{ca.rebalances} rebalances")
    # each scorer wrote one payload per delivered record, in order; the
    # duplicates' payloads agree between the crashed member and the survivor
    pa = {tp: msg for tp, (_, msg) in zip(got_a, out_a.published)}
    pb = {tp: msg for tp, (_, msg) in zip(got_b, out_b.published)}
    if len(out_a.published) != len(got_a) or \
            len(out_b.published) != len(got_b):
        raise AssertionError("group drill: payloads and deliveries differ "
                             "in number")
    dup_err = 0.0
    if dupes:
        a_rows, _, _ = _payload_parts([pa[tp].decode() for tp in sorted(dupes)])
        b_rows, _, _ = _payload_parts([pb[tp].decode() for tp in sorted(dupes)])
        dup_err = float(np.abs(a_rows - b_rows).max())
        if dup_err > CLI_TOL_ALL["atol"]:
            raise AssertionError(f"group drill: duplicate payloads differ "
                                 f"by {dup_err}")
    return {"records": total, "partitions": 10,
            "first_half_rows": first_half, "crashed_rows": crashed_rows,
            "uncommitted": len(uncommitted), "survivor_rows": survivor_rows,
            "duplicates": len(dupes), "duplicate_max_abs_diff": dup_err,
            "survivor_rebalances": ca.rebalances,
            "generation": coord.generation, "seconds": drill_s,
            "first_forward_s": [sa.first_forward_s, sb.first_forward_s]}


WIRE_CREDS = ("smoke", "smoke-secret")
#: Kafka API key → name, for the requests-by-API counts
WIRE_API_NAMES = {0: "produce", 1: "fetch", 2: "list_offsets", 3: "metadata",
                  8: "offset_commit", 9: "offset_fetch",
                  10: "find_coordinator", 11: "join_group", 12: "heartbeat",
                  13: "leave_group", 14: "sync_group", 17: "sasl_handshake",
                  18: "api_versions", 19: "create_topics", 64: "raw_fetch",
                  65: "raw_produce"}


@contextlib.contextmanager
def _wire_requests():
    """Count the wire client's requests by API name (``_request`` is the
    one door every request after the SASL handshake goes through), the
    non-empty ``OutputSequence`` flushes, and the client's own
    ``fetch_raw`` / ``produce_raw`` calls (``counts["client_fetch_raw"]``,
    ``counts["client_produce_raw"]``), which the RAW_FETCH / RAW_PRODUCE
    request counts must equal."""
    counts, flushes = {}, [0]
    real = {name: getattr(KafkaWireBroker, name)
            for name in ("_request", "fetch_raw", "produce_raw")}
    real_flush = OutputSequence.flush

    def request(self, api_key, *a):
        name = WIRE_API_NAMES.get(api_key, str(api_key))
        counts[name] = counts.get(name, 0) + 1
        return real["_request"](self, api_key, *a)

    def counted(name):
        def call(self, *a, **kw):
            counts[f"client_{name}"] = counts.get(f"client_{name}", 0) + 1
            return real[name](self, *a, **kw)
        return call

    def flush(self, *a, **kw):
        n = real_flush(self, *a, **kw)
        flushes[0] += n > 0
        return n

    KafkaWireBroker._request, OutputSequence.flush = request, flush
    KafkaWireBroker.fetch_raw = counted("fetch_raw")
    KafkaWireBroker.produce_raw = counted("produce_raw")
    try:
        yield counts, flushes
    finally:
        for name, fn in real.items():
            setattr(KafkaWireBroker, name, fn)
        OutputSequence.flush = real_flush


def _check_raw_requests(counts, where) -> None:
    """RAW_FETCH and RAW_PRODUCE requests equal the client's own calls,
    and the consumers read through RAW_FETCH."""
    for api, call in (("raw_fetch", "fetch_raw"),
                      ("raw_produce", "produce_raw")):
        if counts.get(api, 0) != counts.get(f"client_{call}", 0):
            raise AssertionError(f"{where}: {counts} — raw requests differ "
                                 f"from the client's calls")
    if not counts.get("raw_fetch"):
        raise AssertionError(f"{where}: no RAW_FETCH request: {counts}")


WIRE_FLAGS = (f"--broker.sasl_username={WIRE_CREDS[0]}",
              f"--broker.sasl_password={WIRE_CREDS[1]}")


@contextlib.contextmanager
def _wire_server(broker):
    """The port's wire server over ``broker`` on 127.0.0.1:0, SASL/PLAIN
    required; yields its ``host:port``."""
    with KafkaWireServer(broker, credentials=WIRE_CREDS) as srv:
        yield f"127.0.0.1:{srv.port}"


def _check_one_produce_per_flush(counts, flushes, where) -> None:
    if counts.get("produce", 0) != flushes[0] or not flushes[0]:
        raise AssertionError(f"{where}: {counts.get('produce', 0)} PRODUCE "
                             f"requests for {flushes[0]} non-empty flushes")


#: the three legs a ``SensorBatches`` reads by, by the consumer call each
#: polls through
SENSOR_LEGS = {"poll_into": "ring", "poll_decoded": "fused",
               "poll": "message lists"}


def jax_sensor_leg(consumer) -> str:
    """The leg the JAX package's ``SensorBatches`` takes for a consumer
    like this one: the columnar ring where the consumer has ``poll_into``
    and its broker ``fetch_raw`` and the frames exist as bytes (a wire hop
    or a durable store; iotml/data/dataset.py:203-224), else the fused
    ``poll_decoded`` over a broker with ``fetch_decode``
    (iotml/data/dataset.py:372-375), else message lists."""
    broker = consumer.broker
    if getattr(consumer, "poll_into", None) is not None and \
            getattr(broker, "fetch_raw", None) is not None:
        durable = getattr(broker, "durable", None)
        if not (obs_tracing.ENABLED and durable is not None) and \
                (durable is None or bool(durable)):
            return "ring"
    if getattr(broker, "fetch_decode", None) is not None:
        return "fused"
    return "message lists"


@contextlib.contextmanager
def _group_legs():
    """Count the rows each ``GroupConsumer`` read by each leg (a call that
    returns rows counts them) and keep the consumers that polled."""
    rows = collections.Counter()
    consumers = []
    real = {name: getattr(GroupConsumer, name) for name in SENSOR_LEGS}

    def spy(name):
        def call(self, *a, **kw):
            res = real[name](self, *a, **kw)
            if self not in consumers:
                consumers.append(self)
            n = 0 if res is None else (res[0] if name == "poll_into"
                                       else len(res[0]) if name ==
                                       "poll_decoded" else len(res))
            rows[SENSOR_LEGS[name]] += int(n)
            return res
        return call

    for name in SENSOR_LEGS:
        setattr(GroupConsumer, name, spy(name))
    try:
        yield rows, consumers
    finally:
        for name, fn in real.items():
            setattr(GroupConsumer, name, fn)


def _wire_group(params_root: str) -> dict:
    """Two ``serve ... group`` members, threads of this process, each
    with its own wire client, over 10 partitions of 30,000 records; the
    leg their batches took (ring, fused or message lists) must be the one
    the JAX package's ``SensorBatches`` takes for the same consumer."""
    backing = Broker()
    n = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01)) \
        .publish(backing, SERVE_TOPIC, n_ticks=300, partitions=10)
    backing.create_topic("model-predictions")
    with _wire_server(backing) as servers:
        argv = [servers, SERVE_TOPIC, "group", "model-predictions", "m1",
                params_root, "--serve.poll_interval_s=0.05",
                "--serve.threshold=5", *WIRE_FLAGS]
        rcs = [None, None]

        def member(i):
            rcs[i] = serve_cli.main(list(argv), max_rounds=8)

        out = io.StringIO()  # both members print here: one stats line each
        with contextlib.redirect_stdout(out), _group_legs() as (legs,
                                                                members):
            t0 = time.perf_counter()
            threads = [threading.Thread(target=member, args=(i,))
                       for i in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or rcs != [0, 0]:
            raise AssertionError(f"group members returned {rcs}:\n"
                                 f"{out.getvalue()}")
    ends = {p: backing.end_offset(SERVE_TOPIC, p) for p in range(10)}
    committed = {p: backing.committed(serve_cli.GROUP, SERVE_TOPIC, p)
                 for p in range(10)}
    scored = backing.end_offset("model-predictions", 0)
    rows = [json.loads(line[len("stats: "):])["rows"]
            for line in out.getvalue().splitlines()
            if line.startswith("stats: ")]
    if committed != ends or not n <= scored <= 2 * n or sum(rows) != scored \
            or n != 30_000:
        raise AssertionError(f"wire group: committed {committed} vs ends "
                             f"{ends}; {scored} scored of {n} (members "
                             f"{rows})")
    taken = sorted(leg for leg, k in legs.items() if k)
    want = sorted({jax_sensor_leg(c) for c in members})
    if taken != want or len(want) != 1 or len(members) < 2:
        raise AssertionError(f"wire group: the members read by {dict(legs)}"
                             f" ({len(members)} consumers), the JAX "
                             f"package's SensorBatches by {want}")
    return {"records": n, "partitions": 10, "scored": scored,
            "member_rows": rows, "seconds": seconds,
            "leg": taken[0], "leg_rows": dict(legs)}


def phase_wire_path(card: str, root: str, cli_info: dict) -> dict:
    """cardata train + predict, serve committed and a two-member serve
    group, over the port's Kafka wire server with SASL/PLAIN."""
    reset_fit_launches()
    reset_launches()
    wire_root = str(Path(root) / "wire")
    backing = cli_app._broker_for("emulator:30000", CLI_TOPIC)
    native.reset_stats()
    with _wire_server(backing) as servers, _wire_requests() as (cli_req,
                                                                cli_fl):
        train = _run_cli("train", wire_root, servers, WIRE_FLAGS)
        launches = fused_train.fused_fit.launches
        by_design = dict(fused_train.fused_fit.launches_by_design)
        train_native = dict(native.stats)
        native.reset_stats()
        predict = _run_cli("predict", wire_root, servers, WIRE_FLAGS)
        predict_native = dict(native.stats)
    if {train["stats"]["broker"], predict["stats"]["broker"]} != {"wire"}:
        raise AssertionError("cardata over host:port did not run on the "
                             "wire client")
    if launches != 1 or by_design["rows"] != 1:
        raise AssertionError(f"cardata train over the wire launched the fit "
                             f"kernel {launches}x ({by_design}), not once "
                             f"through the rows design")
    # the stored state equals cli_path's bit for bit: same records, same
    # seed, and the fit kernel repeats bit for bit (phase 3)
    got, want = (CheckpointManager.load_dir(ArtifactStore(r).download_tree(
        "m1", str(Path(root) / f"wire_check_{i}")))
        for i, r in enumerate((wire_root, root)))
    for tree in ("params", "mu", "nu"):
        a = got["params"] if tree == "params" \
            else getattr(got["opt_state"], tree)
        b = want["params"] if tree == "params" \
            else getattr(want["opt_state"], tree)
        for k in PARAM_NAMES:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"wire checkpoint {tree}/{k} differs "
                                     f"from cli_path's")
    if got["cursors"] != want["cursors"]:
        raise AssertionError(f"wire cursors {got['cursors']} vs "
                             f"{want['cursors']}")
    end = backing.end_offset("model-predictions", 0)
    payloads = [m.value.decode() for m in
                backing.fetch("model-predictions", 0, 0, end + 1)]
    if payloads != cli_info["payloads"]:
        raise AssertionError(f"{end} wire payloads differ from cli_path's "
                             f"{len(cli_info['payloads'])}")
    _check_one_produce_per_flush(cli_req, cli_fl, "cardata predict")
    _check_raw_requests(cli_req, "cardata over the wire")

    # serve committed over a fresh log of the same 30,000 records
    serve_log = cli_app._broker_for("emulator:30000", SERVE_TOPIC)
    native.reset_stats()
    with _wire_server(serve_log) as servers, _wire_requests() as (srv_req,
                                                                  srv_fl):
        srv = _run_serve([servers, SERVE_TOPIC, "committed",
                          "model-predictions", "m1", wire_root,
                          "--serve.poll_interval_s=0", "--serve.threshold=5",
                          *WIRE_FLAGS],
                         max_rounds=2)
    serve_native = dict(native.stats)
    st = srv["stats"]
    end = serve_log.end_offset("model-predictions", 0)
    committed = serve_log.committed(serve_cli.GROUP, SERVE_TOPIC, 0)
    if (end, committed, st["rows"], st["broker"]) != \
            (30_000, 30_000, 30_000, "wire"):
        raise AssertionError(f"wire serve: {end} payloads, cursor "
                             f"{committed}, stats {st}")
    want_rows, x = _recompute(serve_log, got["params"])
    err_first, err_all, anomalies = _check_serve_payloads(
        [m.value.decode() for m in
         serve_log.fetch("model-predictions", 0, 0, end)],
        want_rows, x, 5.0, "wire serve committed")
    _check_one_produce_per_flush(srv_req, srv_fl, "serve committed")
    _check_raw_requests(srv_req, "serve committed")
    group = _wire_group(wire_root)
    launch_counts_now = path_launches()
    if launch_counts_now["fused_fit"] != 1 or \
            any(v for k, v in launch_counts_now.items() if k != "fused_fit"):
        raise AssertionError(f"the wire path launched {launch_counts_now}")
    pst = predict["stats"]
    # every record a fetch carried was decoded by the client; the server
    # encoded those, plus decoded the write-back's produce sets
    fetched = {"predict": predict_native["msgset_encode_rows"] - 10_000,
               "serve": serve_native["msgset_encode_rows"] - 30_000}
    info = {"phase": "wire_path", "card": card,
            "train_seconds": train["seconds"],
            "predict_seconds": predict["seconds"],
            "fit_seconds": train["stats"]["fit_seconds"],
            "kernel_launches": launches,
            "kernel_launches_by_design": by_design,
            "train_decode_rows": train_native["decode_rows"],
            "train_frame_decode_rows": train_native["frame_decode_rows"],
            "predict_frame_decode_rows": predict_native["frame_decode_rows"],
            "predict_frame_decode_s": predict_native["frame_decode_s"],
            "serve_frame_decode_rows": serve_native["frame_decode_rows"],
            "serve_frame_decode_s": serve_native["frame_decode_s"],
            "train_fetched_rows": train_native["msgset_encode_rows"],
            "rows_scored": pst["rows"],
            "predict_score_seconds": pst["score_seconds"],
            "predict_drain_rows_per_s": pst["rows"] / pst["score_seconds"],
            "predict_rows_polled": predict_native["decode_rows"],
            "predict_rows_fetched_and_decoded": fetched["predict"],
            "predict_msgset_decode_s": predict_native["msgset_decode_s"],
            "predict_msgset_encode_s": predict_native["msgset_encode_s"],
            "serve_rows": st["rows"], "serve_seconds": st["serve_seconds"],
            "serve_drain_rows_per_s": st["rows"] / st["serve_seconds"],
            "serve_first_forward_s": st["first_forward_s"],
            "serve_host_pipeline_s": st["host_pipeline_s"],
            "serve_write_back_s": st["write_back_s"],
            "serve_rows_fetched_and_decoded": fetched["serve"],
            "serve_msgset_decode_s": serve_native["msgset_decode_s"],
            "serve_msgset_encode_s": serve_native["msgset_encode_s"],
            "serve_anomalies": anomalies,
            "serve_max_abs_err_first_100": err_first,
            "serve_max_abs_err_all": err_all,
            "requests_by_api": {"cardata": cli_req, "serve_committed":
                                srv_req},
            "flushes": {"cardata": cli_fl[0], "serve_committed": srv_fl[0]},
            "group": group, "payloads_equal_cli_path": True,
            "checkpoint_equal_cli_path": True}
    emit(info)
    return {"launches": launches, "launches_by_design": by_design}


LIVE_TRAIN_GROUP, LIVE_SCORE_GROUP = "cardata-live-train", "cardata-live-score"
#: the live services' model name (their default, Keras h5) and their
#: CLI's SASL flag
LIVE_MODEL = "cardata-live.h5"
LIVE_SASL = ("--sasl", ":".join(WIRE_CREDS))
#: new records a default round (20 x 100) waits for
LIVE_MIN_AVAILABLE = int(20 * 100 * 1.1) + 1
#: the live path's log: emulator:30000's records
LIVE_RECORDS = 30_000
#: how the live CLI starts as a process
LIVE_CMD = [sys.executable, "-m", "iotml_torch.cli.live"]


def _live_clients(servers: str, n: int):
    """``n`` native Kafka clients of ``servers`` with the smoke's SASL
    credentials (a client a service, as one process each holds one)."""
    return [NativeKafkaBroker(servers, sasl_username=WIRE_CREDS[0],
                              sasl_password=WIRE_CREDS[1]) for _ in range(n)]


def _clone_state(state: TrainState) -> TrainState:
    opt = state.opt_state
    return TrainState(step=state.step,
                      params={k: v.clone() for k, v in state.params.items()},
                      opt_state=type(opt)(
                          count=opt.count,
                          mu={k: v.clone() for k, v in opt.mu.items()},
                          nu={k: v.clone() for k, v in opt.nu.items()}))


def _live_trainer(broker, root: str) -> dict:
    """``ContinuousTrainer`` on the card over ``broker`` until the log
    holds no full round; each round's fit is recorded (its batches, the
    state it started from, its launches) and then held against the plain
    version."""
    trainer = ContinuousTrainer(broker, SERVE_TOPIC, ArtifactStore(root),
                                group=LIVE_TRAIN_GROUP)  # the card
    trainer.trainer._ensure_state()
    fit = trainer.trainer.fit_compiled
    rounds, listing = [], [0.0]

    def recorded_fit(batches, epochs=1):
        t0 = time.perf_counter()
        bs = list(next(batches.epochs(1)))  # the poll, decode and batching
        listing[0] += time.perf_counter() - t0
        before = _clone_state(trainer.trainer.state)
        launched = (fused_train.fused_fit.launches,
                    fused_train.fused_fit.launches_by_design["rows"])
        history = fit(bs, epochs)
        rounds.append({"batches": bs, "before": before, "history": history,
                       "launches": fused_train.fused_fit.launches
                       - launched[0],
                       "rows": fused_train.fused_fit.launches_by_design[
                           "rows"] - launched[1],
                       "after": _clone_state(trainer.trainer.state)})
        return history

    trainer.trainer.fit_compiled = recorded_fit
    stats = []
    t0 = time.perf_counter()
    trainer.run(stop=lambda: trainer.available() < trainer.min_available,
                on_round=stats.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    errs = []
    for k, r in enumerate(rounds, 1):
        if (r["launches"], r["rows"]) != (1, 1):
            raise AssertionError(f"live round {k} launched the fit kernel "
                                 f"{r['launches']}x ({r['rows']} rows)")
        xs = torch.from_numpy(np.stack([b.x for b in r["batches"]])).cuda()
        masks = torch.from_numpy(
            np.stack([b.mask for b in r["batches"]])).cuda()
        kernel_out = (r["after"], torch.tensor(r["history"]["loss"]),
                      torch.tensor(r["history"]["accuracy"]))
        p_state, p_loss, p_acc = fused_train.fused_fit_reference(
            r["before"], xs, masks, 1)
        errs.append(check_fit(f"live round {k}", kernel_out,
                              (p_state, p_loss.cpu(), p_acc.cpu()),
                              r["before"].step + len(r["batches"])))
    return {"trainer": trainer, "stats": stats, "seconds": seconds,
            "listing_s": listing[0], "max_abs_err": max(errs),
            "launches": sum(r["launches"] for r in rounds),
            "rows_launches": sum(r["rows"] for r in rounds)}


def _live_score(broker, store_root: str, result_topic: str, group: str,
                carhealth: bool) -> dict:
    """One ``LiveScorer`` on the card from the store's pointer: one drain
    over the whole log, timed."""
    broker.create_topic(result_topic)
    scorer = LiveScorer(broker, SERVE_TOPIC, result_topic,
                        ArtifactStore(store_root), group=group,
                        carhealth_topic="car-health" if carhealth else None)
    artifact = scorer.wait_for_model(timeout_s=30)
    native.reset_stats()
    t0 = time.perf_counter()
    n = scorer.run(max_drains=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"scorer": scorer, "artifact": artifact, "rows": n,
            "seconds": seconds, "native": dict(native.stats)}


def _check_live_carhealth(backing, scorer, want, x) -> dict:
    """The car-health records the card's scorer wrote against a CPU
    ``CarHealthDetector`` fed the CPU recompute's errors batch by batch:
    keys, states and sources equal, EMAs within rtol 1e-5 (errors of two
    float32 forwards), transitions' wall-clock ``t`` aside."""
    cpu = CarHealthDetector(
        feature_names=[f.name for f in KSQL_CAR_SCHEMA.sensor_fields])
    keys = np.concatenate([b.keys[:b.n_valid] for b in SensorBatches(
        StreamConsumer(backing, [f"{SERVE_TOPIC}:0:0"]), batch_size=100,
        keep_keys=True)])
    errs = np.square(want - x).mean(axis=1)
    for lo in range(0, len(errs), 100):
        cpu.update(keys[lo:lo + 100], errs[lo:lo + 100])
    card = scorer.scorer.carhealth
    got = []
    for m in backing.fetch("car-health", 0, 0,
                           backing.end_offset("car-health", 0) + 1):
        rec = json.loads(m.value)
        got.append((m.key, rec["state"], rec["source"], rec["ema"]))
    cpu_recs = [(k, s, src, round(e, 6)) for _, k, s, e, src
                in cpu.transitions]
    ema_err = max(abs(card.ema[k] - e) / max(abs(e), 1e-12)
                  for k, e in cpu.ema.items())
    if [r[:3] for r in got] != [r[:3] for r in cpu_recs] or \
            not np.allclose([r[3] for r in got], [r[3] for r in cpu_recs],
                            rtol=1e-5, atol=1e-6) or \
            card.count != cpu.count or set(card.alerted) != set(cpu.alerted) \
            or ema_err > 1e-5 or len(cpu.ema) != 100:
        raise AssertionError(f"car health on the card vs the CPU: {got} vs "
                             f"{cpu_recs}; EMA rel err {ema_err}")
    return {"transitions": len(got), "cars_alerted": len(card.alerted),
            "cars_seen": len(card.ema), "ema_max_rel_err": ema_err}


def _build_files() -> dict:
    """Every built library and log, with its size and mtime: a child
    process that rebuilt one would change it."""
    out = {}
    for d in (Path(native.CPP) / "build", _build.BUILD):
        for p in sorted(d.glob("*")):
            if p.is_file() and not p.name.endswith(".lock"):
                st = p.stat()
                out[str(p)] = (st.st_size, st.st_mtime_ns)
    return out


def _live_processes(root: str) -> dict:
    """``python -m iotml_torch.cli.live train`` and ``score`` as two OS
    processes on the card over a wire server in this process (SASL), as
    tests/test_live.py runs them: STOP on stdin once every record is
    scored and the trainer's log holds no full round."""
    backing = cli_app._broker_for(f"emulator:{LIVE_RECORDS}", SERVE_TOPIC)
    built = _build_files()
    procs = {}
    with _wire_server(backing) as servers:
        argv = {"train": ["train", servers, SERVE_TOPIC, root, *LIVE_SASL,
                          "--stats", "--max-seconds", "600"],
                "score": ["score", servers, SERVE_TOPIC, "model-predictions",
                          root, *LIVE_SASL, "--stats", "--max-seconds",
                          "600"]}
        t0 = time.perf_counter()
        try:
            for name, args in argv.items():
                procs[name] = subprocess.Popen(
                    [*LIVE_CMD, *args],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            deadline = time.time() + 300
            while time.time() < deadline:
                # every record scored, and no full round left to train
                trained = backing.committed(LIVE_TRAIN_GROUP, SERVE_TOPIC, 0)
                if backing.end_offset("model-predictions", 0) >= LIVE_RECORDS \
                        and trained is not None \
                        and LIVE_RECORDS - trained < LIVE_MIN_AVAILABLE:
                    break
                if any(p.poll() is not None for p in procs.values()):
                    break
                time.sleep(0.2)
            seconds = time.perf_counter() - t0
            outs = {}
            for name, p in procs.items():
                if p.poll() is None:
                    p.stdin.write("STOP\n")
                    p.stdin.flush()
                outs[name] = p.communicate(timeout=120)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for name, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"live {name} exited {p.returncode}:\n"
                                 f"{outs[name][0]}\n{outs[name][1]}")
    lines = {name: [json.loads(line) for line in out.splitlines()
                    if line.startswith("{")]
             for name, (out, _) in outs.items()}
    rounds, drains = lines["train"], lines["score"]
    scored = backing.end_offset("model-predictions", 0)
    if not rounds or rounds[-1]["round"] < 3 or not drains or \
            drains[-1]["scored"] != LIVE_RECORDS or scored != LIVE_RECORDS or \
            drains[-1]["model_updates"] < 1:
        raise AssertionError(f"live processes: rounds {rounds[-1:]}, "
                             f"drains {drains[-1:]}, {scored} predictions")
    if _build_files() != built:
        raise AssertionError("a live child process rebuilt a library")
    return {"rounds": rounds[-1]["round"],
            "records_trained": rounds[-1]["records_cum"],
            "scored": drains[-1]["scored"],
            "model_updates": drains[-1]["model_updates"],
            "artifact": drains[-1]["artifact"],
            "seconds_to_done": seconds, "no_rebuild": True}


def phase_live_path(card: str, root: str) -> dict:
    """The continuous services over the native client: the trainer and
    the scorer in this process, then both CLIs as OS processes."""
    reset_fit_launches()
    reset_launches()
    backing = cli_app._broker_for(f"emulator:{LIVE_RECORDS}", SERVE_TOPIC)
    store_root = str(Path(root) / "live")
    with _wire_server(backing) as servers:
        clients = _live_clients(servers, 3)
        try:
            native.reset_stats()
            tr = _live_trainer(clients[0], store_root)
            train_native = dict(native.stats)
            launches = fused_train.fused_fit.launches
            by_design = dict(fused_train.fused_fit.launches_by_design)
            trainer = tr["trainer"]
            last = f"{LIVE_MODEL}.r{trainer.rounds}"
            if trainer.store.get_text(f"{LIVE_MODEL}.latest") != last or \
                    trainer.rounds < 3:
                raise AssertionError(f"live trainer: {trainer.rounds} "
                                     f"rounds, pointer "
                                     f"{trainer.store.get_text(LIVE_MODEL + '.latest')}")
            positions = trainer.consumer.positions()
            committed = [(t, p, backing.committed(LIVE_TRAIN_GROUP, t, p))
                         for t, p, _ in positions]
            if committed != positions:
                raise AssertionError(f"live trainer committed {committed}, "
                                     f"positions {positions}")
            health = _live_score(clients[1], store_root, "model-predictions",
                                 LIVE_SCORE_GROUP, carhealth=True)
            plain = _live_score(clients[2], store_root,
                                "model-predictions-no-health",
                                LIVE_SCORE_GROUP + "-no-health",
                                carhealth=False)
        finally:
            for c in clients:
                c.close()
    launch_counts_now = path_launches()
    if launch_counts_now["fused_fit"] != launches or \
            any(v for k, v in launch_counts_now.items() if k != "fused_fit"):
        raise AssertionError(f"the live path launched {launch_counts_now}")
    if launches != trainer.rounds or by_design["rows"] != launches:
        raise AssertionError(f"live trainer: {launches} fit launches "
                             f"({by_design}) for {trainer.rounds} rounds")
    if health["artifact"] != last or health["rows"] != LIVE_RECORDS or \
            plain["rows"] != LIVE_RECORDS:
        raise AssertionError(f"live scorers: {health['artifact']}, "
                             f"{health['rows']} and {plain['rows']} rows")
    sc = health["scorer"]
    if sum(sc.scorer.quality.values()) != LIVE_RECORDS:
        raise AssertionError(f"live quality counts {sc.scorer.quality}")
    params = autoencoder_params_from_h5(ArtifactStore(store_root).download(
        last, str(Path(root) / "live_check.h5")))
    want, x = _recompute(backing, params)
    payloads = [m.value.decode() for m in
                backing.fetch("model-predictions", 0, 0, LIVE_RECORDS)]
    err_first, err_all, anomalies = _check_serve_payloads(
        payloads, want, x, 5.0, "live scorer")
    if [m.value.decode() for m in backing.fetch(
            "model-predictions-no-health", 0, 0, LIVE_RECORDS)] != payloads:
        raise AssertionError("the live scorer without car health wrote "
                             "other payloads")
    carhealth = _check_live_carhealth(backing, sc, want, x)
    processes = _live_processes(str(Path(root) / "live_cli"))
    stats = tr["stats"]
    n_rounds = len(stats)
    split = {"host_pipeline_s": (tr["listing_s"]
                                 + trainer.seconds["host_pipeline"])
             / n_rounds,
             "device_compute_s": trainer.seconds["device_compute"]
             / n_rounds,
             "publish_s": trainer.seconds["publish"] / n_rounds,
             "commit_s": trainer.seconds["commit"] / n_rounds}
    round_s = [s["seconds"] for s in stats]
    info = {"phase": "live_path", "card": card,
            "rounds": n_rounds, "records_trained": trainer.records_trained,
            "losses": [s["loss"] for s in stats],
            "kernel_launches": launches,
            "kernel_launches_by_design": by_design,
            "fit_max_abs_err": tr["max_abs_err"],
            "round_seconds": round_s,
            "round_seconds_mean": sum(round_s) / n_rounds,
            "round_split_mean": split,
            "rounds_per_s": n_rounds / sum(round_s),
            "records_trained_per_s": trainer.records_trained / sum(round_s),
            "train_seconds": tr["seconds"],
            "train_fetch_decode_rows": train_native["fetch_decode_rows"],
            "train_fetch_decode_s": train_native["fetch_decode_s"],
            # the server's fetch answers (up to 4,096 records each), in
            # this process
            "train_server_encoded_rows": train_native["msgset_encode_rows"],
            "train_server_encode_s": train_native["msgset_encode_s"],
            "pointer": last, "committed_equal_positions": True,
            "score_rows": health["rows"],
            "score_seconds": health["seconds"],
            "score_rows_per_s": health["rows"] / health["seconds"],
            "score_no_health_seconds": plain["seconds"],
            "score_no_health_rows_per_s": plain["rows"] / plain["seconds"],
            "score_fetch_decode_rows": health["native"]["fetch_decode_rows"],
            "score_fetch_decode_s": health["native"]["fetch_decode_s"],
            "score_server_encoded_rows":
                health["native"]["msgset_encode_rows"],
            "score_server_encode_s": health["native"]["msgset_encode_s"],
            "score_server_decode_s": health["native"]["msgset_decode_s"],
            "score_format_s": health["native"]["format_s"],
            "score_host_pipeline_s": sc.scorer.seconds["host_pipeline"],
            "score_device_s": sc.scorer.seconds["device_compute"],
            "score_write_back_s": sc.scorer.seconds["write_back"],
            "score_quality": sc.scorer.quality,
            "score_anomalies": anomalies,
            "score_max_abs_err_first_100": err_first,
            "score_max_abs_err_all": err_all,
            "carhealth": carhealth, "processes": processes}
    emit(info)
    return {"launches": launches, "launches_by_design": by_design,
            "round_seconds_mean": info["round_seconds_mean"]}


#: the lifecycle path's groups, its crash point and its least rounds
LC_GROUP, LC_REF_GROUP = "lifecycle-train", "lifecycle-reference"
LC_SCORE_GROUP = "lifecycle-score"
LC_CRASH_AFTER = 3
LC_MIN_ROUNDS = 6
#: rows the registry-following scorer drains after each training round
LC_DRAIN_ROWS = 1000
#: the A/B gate as the rollback drill sets it (iotml/mlops/drill.py)
LC_GATE = dict(min_records=300, epsilon=0.02)
#: Keras names of the autoencoder's layers in the h5 file
LC_KERAS = ("dense", "dense_1", "dense_2", "dense_3")


def _median_ms(fn, reps: int = 20) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _check_keras_file(path: str, params) -> None:
    """The stored file, opened by the port's reader: its attributes the
    strings the exporter builds, byte for byte; its datasets the trained
    params, bit for bit."""
    f = hdf5.File(path)
    want = {"backend": b"tensorflow", "keras_version": b"2.2.4-tf",
            "model_config": h5_export._model_config(
                18, [14, 7, 7, 18], CAR_AUTOENCODER.activity_l1,
                "reference").encode(),
            "training_config": h5_export._TRAINING_CONFIG.encode()}
    for key, value in want.items():
        if f.attrs[key] != value:
            raise AssertionError(f"h5 attribute {key!r} differs from the "
                                 f"exporter's string")
    mw = f["model_weights"]
    if list(mw.attrs["layer_names"]) != [b"input_1", *(
            n.encode() for n in LC_KERAS)] or \
            mw.attrs["layer_names"].dtype != np.dtype("S7") or \
            mw["input_1"].attrs["weight_names"].shape != (0,):
        raise AssertionError("h5 layer_names / input_1 weight_names differ")
    tree = params_to_jax(params)
    for layer, kname in zip(("encoder0", "encoder1", "decoder0", "decoder1"),
                            LC_KERAS):
        if list(mw[kname].attrs["weight_names"]) != [
                f"{kname}/kernel:0".encode(), f"{kname}/bias:0".encode()]:
            raise AssertionError(f"h5 weight_names of {kname} differ")
        for leaf in ("kernel", "bias"):
            got = np.asarray(mw[f"{kname}/{kname}/{leaf}:0"])
            if got.dtype != np.float32 or \
                    got.tobytes() != tree[layer][leaf].tobytes():
                raise AssertionError(f"h5 {kname}/{leaf} differs from the "
                                     f"trained params")


def _check_imported(got: dict, want: dict, where: str) -> None:
    """The importer's params bit-equal to the params that were exported
    (CPU tensors both)."""
    if set(got) != set(want) or any(
            got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
            or got[k].numpy().tobytes() != want[k].numpy().tobytes()
            for k in want):
        raise AssertionError(f"{where}: the imported params differ from "
                             f"the exported ones")


def _lc_h5_cli(root: str) -> dict:
    """cardata train to ``model1.h5`` (one fit launch, through rows), the
    file checked, then predict from it against a CPU recompute."""
    reset_fit_launches()
    with _recording(cli_app, "Trainer") as trainers:
        train = _run_cli("train", root, model="model1.h5")
    launches = fused_train.fused_fit.launches
    if launches != 1 or fused_train.fused_fit.launches_by_design["rows"] != 1:
        raise AssertionError(f"cardata train model1.h5 launched the fit "
                             f"kernel {launches}x, not once through rows")
    state = trainers[0].result.state
    path = str(Path(root) / "model1.h5")
    _check_keras_file(path, state.params)
    with open(path, "rb") as fh:
        blob = fh.read()
    host = {k: v.cpu() for k, v in state.params.items()}
    _check_imported(params_from_h5_bytes(blob), host, "model1.h5")
    encode_ms = _median_ms(lambda: params_to_h5_bytes(host))
    decode_ms = _median_ms(lambda: params_from_h5_bytes(blob))
    predict = _run_cli("predict", root, model="model1.h5")
    if fused_train.fused_fit.launches != 1:
        raise AssertionError("cardata predict launched the fit kernel")
    broker = predict["broker"]
    end = broker.end_offset("model-predictions", 0)
    payloads = [m.value.decode()
                for m in broker.fetch("model-predictions", 0, 0, end + 1)]
    check = SensorBatches(StreamConsumer(broker, [f"{CLI_TOPIC}:0:0"]),
                          batch_size=100, skip=100, take=100)
    x = torch.from_numpy(np.concatenate([b.x for b in check]))
    with torch.no_grad():
        want = torch.func.functional_call(
            CAR_AUTOENCODER.build("cpu"), host, (x,)).numpy()
    got = np.array([np.array(p.strip("[]").split(), np.float64)
                    for p in payloads])
    err_first = float(np.abs(got[:100] - want[:100]).max())
    err_all = float(np.abs(got - want).max())
    if got.shape != (10_000, 18) or not np.isfinite(got).all() \
            or not np.allclose(got[:100], want[:100], **CLI_TOL_FIRST) \
            or not np.allclose(got, want, **CLI_TOL_ALL):
        raise AssertionError(f"h5 predict payloads disagree with a CPU "
                             f"recompute: first 100 max {err_first}, all "
                             f"max {err_all}")
    return {"launches": launches, "h5_bytes": len(blob),
            "h5_encode_ms": encode_ms, "h5_decode_ms": decode_ms,
            "train_seconds": train["seconds"],
            "predict_seconds": predict["seconds"],
            "predict_rows": len(payloads),
            "max_abs_err_first_100": err_first, "max_abs_err_all": err_all}


def _lc_trainer(client, root: str, group: str) -> ContinuousTrainer:
    """A registry-mode trainer on the card: every round snapshotted and
    published (cadence 0), serving promoted at each commit."""
    registry = ModelRegistry(root)
    registry.recover()
    return ContinuousTrainer(client, SERVE_TOPIC, None, group=group,
                             checkpointer=AsyncCheckpointer(registry))


def _lc_commit_trails(backing, trainer) -> None:
    """Committed offsets at or below the newest durable manifest's (the
    committed ones read first: a manifest read after them is at least as
    new as any whose commit they show)."""
    committed = {(SERVE_TOPIC, p): backing.committed(trainer.group,
                                                     SERVE_TOPIC, p)
                 for p in range(backing.topic(SERVE_TOPIC).partitions)}
    latest = trainer.registry.latest()
    newest = {} if latest is None else {
        (t, p): o for t, p, o in trainer.registry.manifest(latest).offsets}
    for key, off in committed.items():
        if off is not None and off > newest.get(key, 0):
            raise AssertionError(f"committed {key} = {off} past the newest "
                                 f"durable manifest's {newest.get(key)}")


def _lc_rounds(trainer, backing, max_rounds=None, scorer=None) -> list:
    """Rounds until the log holds no full round (or ``max_rounds``): one
    fit launch through rows each, the commit checked to trail durability;
    ``scorer`` (a registry-following LiveScorer) swaps and drains
    ``LC_DRAIN_ROWS`` rows between rounds."""
    stats = []
    while trainer.available() >= trainer.min_available and \
            (max_rounds is None or len(stats) < max_rounds):
        launched = (fused_train.fused_fit.launches,
                    fused_train.fused_fit.launches_by_design["rows"])
        s = trainer.train_round()
        if (fused_train.fused_fit.launches - launched[0],
                fused_train.fused_fit.launches_by_design["rows"]
                - launched[1]) != (1, 1):
            raise AssertionError("a registry round did not launch the fit "
                                 "kernel exactly once through rows")
        stats.append(s)
        _lc_commit_trails(backing, trainer)
        if scorer is not None:
            scorer.maybe_swap()
            scorer.scorer.score_available(max_rows=LC_DRAIN_ROWS)
    return stats


def _lc_swap(svc, timeout_s: float = 30.0) -> None:
    """Poll the scorer's channel until it swaps (the serving flip just
    made must land)."""
    deadline = time.monotonic() + timeout_s
    while not svc.maybe_swap():
        if time.monotonic() > deadline:
            raise AssertionError("the serving scorer never swapped")


def _lc_states_close(tag: str, got: TrainState, want: TrainState) -> float:
    errs = []
    for tree in ("params", "mu", "nu"):
        a = got.params if tree == "params" else getattr(got.opt_state, tree)
        b = want.params if tree == "params" else getattr(want.opt_state,
                                                         tree)
        for k in PARAM_NAMES:
            errs.append(check_close(f"{tag} {tree}/{k}", a[k], b[k],
                                    **RESUME_TOL))
    if (got.step, got.opt_state.count) != (want.step, want.opt_state.count):
        raise AssertionError(f"{tag}: step/count {got.step}/"
                             f"{got.opt_state.count}, want {want.step}/"
                             f"{want.opt_state.count}")
    return max(errs)


def phase_lifecycle_path(card: str, root: str, live_info: dict) -> dict:
    """The model lifecycle on the card: the cardata CLI through Keras h5;
    the live services in registry mode with a crash and a resume, against
    an uninterrupted run; an A/B rollback of a degraded candidate."""
    reset_launches()
    cli = _lc_h5_cli(str(Path(root) / "lifecycle_cli"))
    reset_fit_launches()
    backing = cli_app._broker_for(f"emulator:{LIVE_RECORDS}", SERVE_TOPIC)
    n_parts = backing.topic(SERVE_TOPIC).partitions
    ref_root, reg_root = (str(Path(root) / "lifecycle" / d)
                          for d in ("reference", "registry"))
    with _wire_server(backing) as servers:
        clients = _live_clients(servers, 6)
        try:
            # the uninterrupted run of the same rounds
            ref = _lc_trainer(clients[0], ref_root, LC_REF_GROUP)
            ref.checkpointer.start()
            ref_stats = _lc_rounds(ref, backing)
            torch.cuda.synchronize()
            ref.close()
            if len(ref_stats) < LC_MIN_ROUNDS:
                raise AssertionError(f"the reference run trained "
                                     f"{len(ref_stats)} rounds")
            ref_state = _clone_state(ref.trainer.state)
            ck = ref.checkpointer
            snapshot_ms = ck.seconds["snapshot"] / len(ref_stats) * 1e3
            write_ms = (ck.seconds["serialize"] + ck.seconds["fsync"]) \
                / ck.written * 1e3
            # the scorer follows the serving channel while the trainer
            # runs, draining between rounds
            svc = LiveScorer(clients[1], SERVE_TOPIC, "lifecycle-predictions",
                             None, registry=ModelRegistry(reg_root),
                             group=LC_SCORE_GROUP, carhealth_topic=None)
            swaps = []
            real_set = svc.scorer.set_params

            def set_params(params, version=None):
                real_set(params, version=version)
                swaps.append((version, svc.scorer.scored))

            svc.scorer.set_params = set_params
            # super-batches of LC_DRAIN_ROWS, so a drain between rounds
            # stops there and the swaps land mid-stream
            svc.scorer.max_super_batches = LC_DRAIN_ROWS // 100
            first = _lc_trainer(clients[2], reg_root, LC_GROUP)
            first.checkpointer.start()
            first_stats = _lc_rounds(first, backing,
                                     max_rounds=LC_CRASH_AFTER - 1,
                                     scorer=svc)
            # the writer stops before the last round, so that round's
            # snapshot is never written: the crash loses it, and the
            # resume re-trains a round the committed offsets had not
            # passed
            first.checkpointer.stop(flush=True)
            first_stats += _lc_rounds(first, backing, max_rounds=1,
                                      scorer=svc)
            lost = first.checkpointer.pending()
            if len(first_stats) != LC_CRASH_AFTER or lost != 1:
                raise AssertionError(f"the crashed run trained "
                                     f"{len(first_stats)} rounds and left "
                                     f"{lost} snapshots unwritten")
            clients[2].close()
            registry = ModelRegistry(reg_root)
            swept = registry.recover()
            tip = registry.manifest(registry.latest())
            t0 = time.perf_counter()
            second = _lc_trainer(clients[3], reg_root, LC_GROUP)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            positions = second.consumer.positions()
            if tip.version != LC_CRASH_AFTER - 1 or \
                    second.restored_version != tip.version or \
                    second.trainer.state.step != tip.step or \
                    second.trainer.state.opt_state.count != tip.step or \
                    positions != tip.offsets:
                raise AssertionError(
                    f"the resumed trainer: version "
                    f"{second.restored_version}, step "
                    f"{second.trainer.state.step}, positions {positions}; "
                    f"the tip: v{tip.version}, step {tip.step}, offsets "
                    f"{tip.offsets}")
            second.checkpointer.start()
            second_stats = _lc_rounds(second, backing, scorer=svc)
            torch.cuda.synchronize()
            second.close()
            err = _lc_states_close("resumed vs uninterrupted",
                                   second.trainer.state, ref_state)
            final = registry.manifest(registry.latest())
            ref_final = ref.registry.manifest(ref.registry.latest())
            if final.offsets != ref_final.offsets or \
                    [backing.committed(LC_GROUP, t, p)
                     for t, p, _ in final.offsets] != \
                    [o for _, _, o in final.offsets]:
                raise AssertionError(f"final offsets {final.offsets}, the "
                                     f"reference's {ref_final.offsets}")
            # the scorer ends on the tip, every record scored once
            svc.maybe_swap()
            while svc.scorer.score_available(max_rows=50_000):
                pass
            torch.cuda.synchronize()
            serving = registry.channel("serving")
            if svc.scorer.model_version != final.version or \
                    serving != final.version or \
                    svc.scorer.scored != LIVE_RECORDS or \
                    backing.end_offset("lifecycle-predictions", 0) != \
                    LIVE_RECORDS or \
                    sum(backing.committed(LC_SCORE_GROUP, SERVE_TOPIC, p)
                        for p in range(n_parts)) != LIVE_RECORDS:
                raise AssertionError(
                    f"the registry scorer: version "
                    f"{svc.scorer.model_version} (tip {final.version}, "
                    f"serving {serving}), {svc.scorer.scored} scored")
            tail = swaps[-1][1]
            tip_params = {k: v.cpu() for k, v in
                          second.trainer.state.params.items()}
            _check_imported(params_from_h5_bytes(registry.load_bytes(
                final.version, "model.h5")), tip_params,
                f"registry v{final.version} model.h5")
            payloads = [m.value.decode() for m in backing.fetch(
                "lifecycle-predictions", 0, tail, LIVE_RECORDS)]
            want, x = _recompute(backing, tip_params, start=tail)
            s_first, s_all, _ = _check_serve_payloads(
                payloads, want, x, 5.0, "lifecycle scorer")
            fit_launches = fused_train.fused_fit.launches
            fit_rows = fused_train.fused_fit.launches_by_design["rows"]

            # restore_trainer alone, from the tip
            probe = Trainer(CAR_AUTOENCODER)
            probe._ensure_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored = restore_trainer(probe, registry)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            _lc_states_close("restore_trainer vs the final state",
                             probe.state, second.trainer.state)
            # the A/B rollback: the tip against tip + N(0, 1) noise
            noise = np.random.RandomState(7)
            bad = {k: v + torch.from_numpy(noise.normal(
                0, 1.0, tuple(v.shape)).astype(np.float32))
                for k, v in tip_params.items()}
            cand = registry.publish({"model.h5": params_to_h5_bytes(bad)},
                                    metrics={"degraded": 1.0}).version
            ab = ABRollout(clients[4], SERVE_TOPIC, registry, final.version,
                           cand, gate=RolloutGate(**LC_GATE), threshold=5.0,
                           deploy_candidate=True, from_start=True,
                           group_prefix="lifecycle-ab")
            t_deployed = time.perf_counter()
            _lc_swap(svc)
            promote_to_swap_s = time.perf_counter() - t_deployed
            if svc.scorer.model_version != cand:
                raise AssertionError("the serving scorer did not take the "
                                     "deployed candidate")
            t0 = time.perf_counter()
            while ab.step(max_rows=5_000):
                pass
            torch.cuda.synchronize()
            ab_s = time.perf_counter() - t0
            t_rolled = time.perf_counter()
            _lc_swap(svc)
            rollback_to_swap_s = time.perf_counter() - t_rolled
            scored = {side: sc.scored for side, sc in ab.sides.items()}
            ends = {v: backing.end_offset(f"model-predictions.v{v}", 0)
                    for v in (final.version, cand)}
            if ab.decision != "rollback" or \
                    registry.channel("serving") != final.version or \
                    svc.scorer.model_version != final.version or \
                    set(scored.values()) != {LIVE_RECORDS} or \
                    set(ends.values()) != {LIVE_RECORDS}:
                raise AssertionError(f"A/B: decision {ab.decision}, serving "
                                     f"{registry.channel('serving')}, "
                                     f"scored {scored}, topics {ends}")
        finally:
            for c in clients:
                c.close()
    counts = path_launches()
    if counts["fused_fit"] != fit_launches or \
            any(v for k, v in counts.items() if k != "fused_fit"):
        raise AssertionError(f"restore, watcher and rollout launched "
                             f"{counts}")
    n_rounds = len(ref_stats)
    if fit_launches != n_rounds + len(first_stats) + len(second_stats) \
            or fit_rows != fit_launches:
        raise AssertionError(f"{fit_launches} fit launches for "
                             f"{n_rounds} + {len(first_stats)} + "
                             f"{len(second_stats)} rounds")
    round_s = [s["seconds"] for s in ref_stats]
    info = {"phase": "lifecycle_path", "card": card, "h5_cli": cli,
            "rounds": n_rounds, "crash_after_round": LC_CRASH_AFTER,
            "snapshots_lost_in_crash": lost, "torn_swept": swept,
            "resumed_from_version": tip.version,
            "resumed_rounds": len(second_stats),
            "final_version": final.version,
            "resume_max_abs_err": err,
            "losses": [s["loss"] for s in ref_stats],
            "round_seconds_mean": sum(round_s) / n_rounds,
            "live_path_round_seconds_mean": live_info["round_seconds_mean"],
            "snapshot_ms": snapshot_ms, "write_ms": write_ms,
            "write_ms_split": {"serialize": ck.seconds["serialize"]
                               / ck.written * 1e3,
                               "fsync": ck.seconds["fsync"] / ck.written
                               * 1e3},
            "resume_s": resume_s, "restore_trainer_s": restore_s,
            "restore_step": restored.step,
            "promote_to_swap_s": promote_to_swap_s,
            "rollback_to_swap_s": rollback_to_swap_s,
            "scorer_swaps": len(swaps), "scorer_tail_rows":
                LIVE_RECORDS - tail,
            "scorer_max_abs_err_first_100": s_first,
            "scorer_max_abs_err_all": s_all,
            "ab": {"decision": ab.decision, "rows": sum(scored.values()),
                   "seconds": ab_s,
                   "rows_per_s": sum(scored.values()) / ab_s,
                   "decided_at_s": ab.decided_at_s,
                   "baseline": ab.quality("baseline"),
                   "candidate": ab.quality("candidate")},
            "kernel_launches": fit_launches + cli["launches"]}
    emit(info)
    return {"launches": fit_launches + cli["launches"],
            "launches_by_design": {
                d: (fit_launches + cli["launches"] if d == "rows" else 0)
                for d in fused_train.DESIGNS}}


#: the online drill at its defaults, as deploy/smoke.sh runs JAX's
ONLINE_DRILL_ARGV = ["drill", "--seed", "7", "--json"]
#: the card drill's histogram AUCs against the CPU drill's
ONLINE_AUC_TOL = 0.01
#: the refit check: tests/test_online.py:344's regional-drift stream (80
#: ticks, then 120 with the drift) at the config's window of 100, with 50
#: cars, so the detector's burn-in passes before the drift
ONLINE_WINDOW = 100
ONLINE_REFIT_CARS = 50
ONLINE_GROUP = "cardata-online"
#: `python -m iotml_torch.online run` as a process, over LIVE_RECORDS
ONLINE_CMD = [sys.executable, "-m", "iotml_torch.online"]
ONLINE_RUN_SECONDS = 10


@contextlib.contextmanager
def _swapped(owner, name: str, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


def _check_all_rows(where: str) -> None:
    """Every fit launch since the counts were set to 0 went through the
    rows design (B = 50 or 100 at (18, 14, 7))."""
    fit = fused_train.fused_fit
    if fit.launches_by_design["rows"] != fit.launches:
        raise AssertionError(f"{where}: fit launches by design "
                             f"{fit.launches_by_design}")


def _online_learner_class(made: list, check: bool):
    """An ``OnlineLearner`` that lists itself in ``made`` and logs each
    refit: its windows, its fused-fit launches (the counts set to 0 just
    before and read just after, then added back to the running counts)
    and seconds.  With ``check``, each refit is held against a plain
    step-loop refit of the same windows from the same state on the card
    (updates are functional: the start state is never overwritten)."""

    class Recorded(OnlineLearner):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.refit_log = []
            #: (K, seconds) of every training call, in order
            self.calls = []
            made.append(self)

        def _update(self, b):
            t0 = time.perf_counter()
            loss = super()._update(b)
            self.calls.append((1, time.perf_counter() - t0))
            return loss

        def _update_group(self, bs):
            t0 = time.perf_counter()
            losses = super()._update_group(bs)
            self.calls.append((len(bs), time.perf_counter() - t0))
            return losses

        def _refit(self):
            wins, start = list(self.buffer), self.trainer.state
            prior = fused_train.fused_fit.launches
            prior_design = dict(fused_train.fused_fit.launches_by_design)
            reset_fit_launches()
            t0 = time.perf_counter()
            super()._refit()
            seconds = time.perf_counter() - t0
            n = fused_train.fused_fit.launches
            fused_train.fused_fit.launches = prior + n
            for d, c in fused_train.fused_fit.launches_by_design.items():
                fused_train.fused_fit.launches_by_design[d] = \
                    prior_design[d] + c
            if n != self.refit_launches(len(wins)):
                raise AssertionError(
                    f"a refit over {len(wins)} windows launched the fit "
                    f"{n} times, not {self.refit_launches(len(wins))}")
            entry = {"windows": len(wins), "launches": n,
                     "seconds": seconds}
            if check:
                entry.update(self._check_refit(start, wins))
            self.refit_log.append(entry)

        def _check_refit(self, start, wins) -> dict:
            tr, st = self.trainer, start
            for _ in range(self.policy.refit_epochs):
                for x, m, _n in wins:
                    st, metrics = tr._step(st, x, x, m)
            got = tr.state
            if (got.step, got.opt_state.count, got.opt_state.inner.count) \
                    != (st.step, st.opt_state.count, st.opt_state.inner.count):
                raise AssertionError("refit counts differ from the step loop")
            err = check_close("refit last_loss",
                              torch.tensor([self.last_loss]),
                              torch.tensor([float(metrics["loss"])]),
                              **METRIC_TOL)
            for k in PARAM_NAMES:
                err = max(err, check_close(f"refit params {k}",
                                           got.params[k], st.params[k],
                                           **STATE_TOL))
                for tree in ("mu", "nu"):
                    err = max(err, check_close(
                        f"refit {tree} {k}",
                        getattr(got.opt_state.inner, tree)[k],
                        getattr(st.opt_state.inner, tree)[k], **STATE_TOL))
            return {"max_abs_err": err}

    return Recorded


def _online_drill(device) -> dict:
    """``python -m iotml_torch.online drill --seed 7 --json`` through its
    entry point on ``device`` (None: the card, as a user calls it)."""
    made = []
    out = io.StringIO()
    with _swapped(online_drill, "OnlineLearner",
                  _online_learner_class(made, check=False)), \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = online_cli.main(ONLINE_DRILL_ARGV, device=device)
        seconds = time.perf_counter() - t0
    report = json.loads(out.getvalue())
    if rc != (0 if report["ok"] else 1) or len(made) != 1:
        raise AssertionError(f"drill exit {rc} against verdict "
                             f"{report['ok']}; {len(made)} learners")
    learner = made[0]
    details = {i["name"]: i["detail"] for i in report["invariants"]}
    swaps = re.search(r"after (\d+) hot-swaps",
                      details["fleet_hot_swapped"])
    return {"report": report, "learner": learner, "seconds": seconds,
            "outcomes": {
                "invariants": [(i["name"], i["ok"])
                               for i in report["invariants"]],
                "ok": report["ok"],
                "detect_records": report["slos"]["detect_records"],
                "published": report["published"],
                "scored": report["scored"],
                "adaptations": [tuple(a) for a in learner.adaptations],
                "versions": len(learner.published_versions),
                "hot_swaps": int(swaps.group(1)) if swaps else None}}


def _windows_timing(learner) -> dict:
    """Training calls of ``learner`` (transfer, K steps, the loss sync)
    by group size K (1 = a single window): the median ms a window over
    the warm calls, the first call of the process's first size apart
    (it pays the card's cold start), and windows/s over all calls."""
    first_k, first_s = learner.calls[0]
    by_k = {}
    for k, sec in learner.calls[1:]:
        by_k.setdefault(k, []).append(sec)
    windows = sum(k for k, _s in learner.calls)
    seconds = sum(sec for _k, sec in learner.calls)
    return {"windows_per_s": windows / seconds,
            "ms_per_window": {str(k): 1e3 * float(np.median(v)) / k
                              for k, v in sorted(by_k.items())},
            "calls": {str(k): len(v) for k, v in sorted(by_k.items())},
            "first_call": {"k": first_k, "ms": 1e3 * first_s}}


def _step_profile(learner, root: str) -> dict:
    """One training step of ``learner`` on its newest buffered window in
    an ``obs.profile`` capture: the device operations it ran, the union
    of their intervals (device ms) and its share of the window (the step
    and its loss sync; transfer-free: the window is already on the
    card)."""
    x, m, _n = learner.buffer[-1]
    tr = learner.trainer
    with obs_profile.trace(f"{root}/step_profile") as cap:
        _state, metrics = tr._step(tr.state, x, x, m)
        float(metrics["loss"])
    s = cap.summary(top=5)
    return {"cuda_kernels": s["device_ops"], "device_ms": s["device_ms"],
            "wall_ms_profiled": s["window_ms"],
            "device_busy_share": s["busy_share"] if s["device_ops"]
            else None, "top": s["top"]}


def _online_run_process(root: str) -> dict:
    """``python -m iotml_torch.online run`` as an OS process on the card
    over the port's wire server (127.0.0.1:0) holding LIVE_RECORDS
    records, with ``--registry``: it must publish, and the group's
    committed offsets must trail the newest manifest."""
    backing = cli_app._broker_for(f"emulator:{LIVE_RECORDS}", SERVE_TOPIC)
    reg_root = str(Path(root) / "online_run_registry")
    built = _build_files()
    with KafkaWireServer(backing) as srv:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [*ONLINE_CMD, "run", "--servers", f"127.0.0.1:{srv.port}",
             "--registry", reg_root, "--max-seconds",
             str(ONLINE_RUN_SECONDS)],
            capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"online run exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = [json.loads(s) for s in proc.stdout.splitlines()
             if s.startswith("{")]
    final = lines[-1]
    reg = ModelRegistry(reg_root)
    latest = reg.latest()
    if latest is None or final["updates"] < 1:
        raise AssertionError(f"online run published nothing: {final}")
    stamped = {p: off for _t, p, off in reg.manifest(latest).offsets}
    committed = {p: backing.committed(ONLINE_GROUP, SERVE_TOPIC, p)
                 for p in stamped}
    if any(c is None or c > stamped[p] for p, c in committed.items()):
        raise AssertionError(f"online run committed {committed} past the "
                             f"newest manifest {stamped}")
    if _build_files() != built:
        raise AssertionError("the online run process rebuilt a library")
    return {"rc": 0, "seconds": seconds, "update_lines": len(lines) - 1,
            "updates": final["updates"],
            "records_trained": final["records_trained"],
            "adaptations": final["adaptations"],
            "versions": len(reg.versions()), "newest": latest,
            "manifest_offsets": stamped, "committed": committed,
            "no_rebuild": True}


def _online_catch_up(root: str) -> dict:
    """Records/s over the same LIVE_RECORDS backlog, in this process on
    the card, over the native client on the wire server: the learner in
    catch-up (groups of ``fuse`` = 8 windows of 100) against
    ``ContinuousTrainer``'s micro-batch rounds (20 × 100, one fit launch
    each; their launches are the baseline's, not the online path's)."""
    backing = cli_app._broker_for(f"emulator:{LIVE_RECORDS}", SERVE_TOPIC)
    with KafkaWireServer(backing) as srv:
        servers = f"127.0.0.1:{srv.port}"
        made = []
        learner = _online_learner_class(made, check=False)(
            NativeKafkaBroker(servers), SERVE_TOPIC,
            registry=ModelRegistry(str(Path(root) / "online_catch_up")),
            window=ONLINE_WINDOW)
        reset_fit_launches()
        t0 = time.perf_counter()
        windows = learner.process_available()
        online_s = time.perf_counter() - t0
        launches = fused_train.fused_fit.launches
        _check_all_rows("the catch-up drain")
        profile = _step_profile(learner, root)
        learner.close()
        trainer = ContinuousTrainer(
            NativeKafkaBroker(servers), SERVE_TOPIC, None,
            registry=ModelRegistry(str(Path(root) / "online_baseline")),
            group="online-baseline")
        t0 = time.perf_counter()
        while trainer.available() >= trainer.min_available:
            trainer.train_round()
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        trainer.close()
    online_rps = learner.records_trained / online_s
    batch_rps = trainer.records_trained / batch_s
    return {"launches": launches,
            "online": {"windows": windows,
                       "records": learner.records_trained,
                       "seconds": online_s, "records_per_s": online_rps,
                       "host_pipeline_s": learner.seconds["host_pipeline"],
                       "publish_s": learner.seconds["publish"],
                       "device_compute_s": learner.seconds["device_compute"],
                       "step_profile": profile,
                       **_windows_timing(learner)},
            "micro_batch": {"rounds": trainer.rounds,
                            "records": trainer.records_trained,
                            "seconds": batch_s, "records_per_s": batch_rps},
            "online_over_micro_batch": online_rps / batch_rps}


def phase_online_path(card: str, root: str) -> dict:
    """Online learning (ROADMAP A8) on the card: the drift-adapt-swap
    drill at its defaults on the card and on the CPU, which must agree;
    refits on B1 held against the step loop; ``python -m
    iotml_torch.online run`` as a process; catch-up records/s beside the
    micro-batch trainer's."""
    reset_launches()
    reset_fit_launches()
    card_drill = _online_drill(None)
    drill_launches = fused_train.fused_fit.launches
    _check_all_rows("the drill")
    learner = card_drill["learner"]
    refit_launches = sum(r["launches"] for r in learner.refit_log)
    if drill_launches != 1 + refit_launches:
        raise AssertionError(f"the drill launched the fit {drill_launches} "
                             f"times: 1 pre-train + {refit_launches} refit")
    cpu_drill = _online_drill("cpu")
    got, want = card_drill["outcomes"], cpu_drill["outcomes"]
    if got != want:
        raise AssertionError(f"the card's drill {got} differs from the "
                             f"CPU's {want}")
    aucs = {}
    for key in ("auc_pre", "auc_during", "auc_post"):
        a = card_drill["report"]["slos"][key]
        b = cpu_drill["report"]["slos"][key]
        if (a is None) != (b is None) or \
                (a is not None and abs(a - b) > ONLINE_AUC_TOL):
            raise AssertionError(f"drill {key}: card {a}, CPU {b}")
        aucs[key] = {"card": a, "cpu": b}
    verdicts = {"card": "PASS" if card_drill["report"]["ok"] else "FAIL",
                "cpu": "PASS" if cpu_drill["report"]["ok"] else "FAIL"}
    # refits on the card, each held against the plain step loop
    made = []
    lrn = _online_learner_class(made, check=True)(
        Broker(), "T", window=ONLINE_WINDOW, publish_every=10**9,
        policy=AdaptationPolicy(action="refit"))
    fleet = AdversarialFleet(
        FleetScenario(num_cars=ONLINE_REFIT_CARS, failure_rate=0.0,
                      seed=7), scenario_condition("regional-drift",
                                                  drift_tick=80))
    reset_fit_launches()
    for ticks in (80, 120):
        fleet.publish_stream(lrn.broker, "T", n_ticks=ticks)
        lrn.process_available()
    check_launches = fused_train.fused_fit.launches
    _check_all_rows("the refit check")
    if not lrn.refit_log or check_launches != sum(
            r["launches"] for r in lrn.refit_log):
        raise AssertionError(f"refit check: adaptations {lrn.adaptations}, "
                             f"{check_launches} launches for "
                             f"{lrn.refit_log}")
    run = _online_run_process(root)
    catch_up = _online_catch_up(root)
    attention = {k: v for k, v in path_launches().items() if k != "fused_fit"}
    if any(attention.values()):
        raise AssertionError(f"the online path launched {attention}")
    refits = learner.refit_log + lrn.refit_log
    launches = drill_launches + check_launches + catch_up["launches"]
    info = {"phase": "online_path", "card": card,
            "drill": {"verdict": verdicts, "outcomes": got, "auc": aucs,
                      "slos": card_drill["report"]["slos"],
                      "seconds": {"card": card_drill["seconds"],
                                  "cpu": cpu_drill["seconds"]},
                      "b1_launches": {"pretrain": 1,
                                      "refits": refit_launches},
                      "publishes": len(learner.published_versions),
                      "offsets_lag": learner.checkpointer.offsets_lag,
                      "hot_swaps": got["hot_swaps"],
                      "refit_ms": [1e3 * r["seconds"]
                                   for r in learner.refit_log],
                      **_windows_timing(learner)},
            "refit_check": {"adaptations": lrn.adaptations,
                            "refits": lrn.refit_log,
                            "launches": check_launches,
                            "tolerance": {"params, moments": STATE_TOL,
                                          "last_loss": METRIC_TOL}},
            "ms_per_refit": (1e3 * sum(r["seconds"] for r in refits)
                             / len(refits)),
            "run": run, "catch_up": catch_up,
            "kernel_launches": launches}
    emit(info)
    return {"launches": launches, "counts": attention,
            "launches_by_design": {d: (launches if d == "rows" else 0)
                                   for d in fused_train.DESIGNS}}


# ------------------------------------------------------------------ obs_path
OBS_TOPIC = "SENSOR_DATA_S_AVRO"
#: the fleet rows obs_path publishes with birth headers (main_path's)
OBS_ROWS = 30_000
#: the scorer crash, the trainer stall and the lost checkpoint of obs_path
OBS_CHAOS = [(2, "scorer.poll", "error", {}, 1),
             (1, "trainer.poll", "delay", {"seconds": 0.01}, 2),
             (2, "ckpt.write", "error", {"exc": "OSError"}, 1)]
OBS_CHAOS_ROUNDS = 4


def _obs_broker() -> Broker:
    """main_path's fleet (100 cars, 300 ticks) published into the
    in-process broker; under tracing every record is born traced."""
    broker = Broker()
    FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01)).publish(
        broker, OBS_TOPIC, n_ticks=OBS_ROWS // 100)
    return broker


def _obs_fit(broker, group: str, device=None):
    """main_path's fit, over a consumer: 100 batches of 100 normal rows,
    20 epochs."""
    batches = SensorBatches(StreamConsumer(broker, [f"{OBS_TOPIC}:0:0"],
                                           group=group),
                            batch_size=100, take=100, only_normal=True)
    trainer = Trainer(CAR_AUTOENCODER, device=device)
    hist = trainer.fit_compiled(batches, epochs=20)
    return trainer, hist, batches


def _obs_scorer(broker, params, group: str, device=None) -> StreamScorer:
    out_topic = f"obs-predictions-{group}"
    broker.create_topic(out_topic)
    return StreamScorer(
        CAR_AUTOENCODER, params,
        SensorBatches(StreamConsumer(broker, [f"{OBS_TOPIC}:0:0"],
                                     group=group),
                      batch_size=100, keep_labels=True),
        OutputSequence(broker, out_topic, partition=0), threshold=5.0,
        device=device)


def _payloads(scorer) -> list:
    b, topic = scorer.out.broker, scorer.out.topic
    return [m.value for m in b.fetch(topic, 0, 0, b.end_offset(topic, 0))]


def _quantiles(rows, kind: str, key: str) -> dict:
    by = {}
    for r in rows:
        if r["kind"] == kind:
            by.setdefault(r[key], []).append(r["dur_us"])
    return {k: {"count": len(v), "p50_ms": float(np.percentile(v, 50)) / 1e3,
                "p99_ms": float(np.percentile(v, 99)) / 1e3}
            for k, v in sorted(by.items())}


def _obs_traced(root: str) -> dict:
    """Section 1: the traced fit and drain against an untraced run."""
    runs = {}
    dropped = obs_tracing.spans_dropped.value()
    for traced in (False, True):
        path = f"{root}/spans.jsonl"
        obs_tracing.reset()
        obs_tracing.configure(enabled=traced, sample=1.0,
                              path=path if traced else "")
        # the collector holds 65,536 entries a thread (drop-oldest):
        # flush between the legs, as a scrape would
        flushed = {"spans": 0, "e2e": 0}

        def flush():
            for k, v in obs_tracing.flush().items():
                flushed[k] += v

        broker = _obs_broker()
        flush()
        before = fused_train.fused_fit.launches
        trainer, hist, batches = _obs_fit(broker, "obs-train")
        launches = fused_train.fused_fit.launches - before
        if launches != 1:
            raise AssertionError(f"obs_path's traced={traced} fit launched "
                                 f"B1 {launches}x")
        flush()
        scorer = _obs_scorer(broker, trainer.state.params, "obs-score")
        # a drain of 30,000 rows records ~90,000 entries: a second thread
        # drains the collector meanwhile, as a /metrics scrape does
        done = threading.Event()

        def drainer():
            while not done.wait(0.02):
                flush()

        flusher = threading.Thread(target=drainer, daemon=True)
        flusher.start()
        try:
            n = scorer.score_available()
            torch.cuda.synchronize()
        finally:
            done.set()
            flusher.join()
        flush()
        consumed = batches.consumer.positions()[0][2]
        runs[traced] = {"params": {k: v.cpu() for k, v in
                                   trainer.state.params.items()},
                        "loss": hist["loss"], "scored": n,
                        "payloads": _payloads(scorer),
                        "consumed": consumed, "flushed": flushed}
    obs_tracing.configure(enabled=False, path="")
    off, on = runs[False], runs[True]
    if obs_tracing.spans_dropped.value() != dropped:
        raise AssertionError("the collector dropped spans")
    if off["flushed"] != {"spans": 0, "e2e": 0}:
        raise AssertionError(f"untraced run recorded {off['flushed']}")
    for k in PARAM_NAMES:
        if not torch.equal(off["params"][k], on["params"][k]):
            raise AssertionError(f"tracing changed the trained {k}")
    if on["scored"] != OBS_ROWS or off["scored"] != OBS_ROWS or \
            on["payloads"] != off["payloads"]:
        raise AssertionError("traced payloads differ from untraced ones")
    with open(f"{root}/spans.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    stages = _quantiles(rows, "span", "stage")
    e2e = _quantiles(rows, "e2e", "closer")
    want = {"devsim_publish": OBS_ROWS,
            "consume": on["consumed"] + OBS_ROWS,
            "train": on["consumed"], "score": OBS_ROWS}
    if {k: v["count"] for k, v in stages.items()} != want or \
            {k: v["count"] for k, v in e2e.items()} != \
            {"train": on["consumed"], "score": OBS_ROWS}:
        raise AssertionError(f"span counts {stages} / {e2e}, want {want}")
    return {"stages": stages, "e2e": e2e, "rows": OBS_ROWS,
            "train_rows_consumed": on["consumed"],
            "payloads_equal_untraced": True, "params_equal_untraced": True}


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(port: int) -> tuple:
    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        text = r.read().decode()
    with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
        health = json.loads(r.read())
    return text, health


def _metric(text: str, name: str) -> float:
    """The value of an unlabelled sample in a Prometheus text scrape."""
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    if m is None:
        raise AssertionError(f"{name} missing from the scrape")
    return float(m.group(1))


def _obs_live(root: str) -> dict:
    """Section 2: both live CLIs as processes with ``--metrics-port``,
    scraped while they run and at the end.  Each process starts with an
    empty registry, so its counters are deltas from its start."""
    backing = cli_app._broker_for(f"emulator:{LIVE_RECORDS}", SERVE_TOPIC)
    backing.create_topic("obs-live-preds")
    ports = {"train": _free_port(), "score": _free_port()}
    env = {**os.environ, "IOTML_TRACE": "1"}  # stage liveness beats
    procs, scrapes = {}, {"running": {}, "end": {}}
    with _wire_server(backing) as servers:
        argv = {"train": ["train", servers, SERVE_TOPIC, f"{root}/obs-live",
                          *LIVE_SASL, "--stats", "--max-seconds", "600",
                          "--group", "obs-live-train"],
                "score": ["score", servers, SERVE_TOPIC, "obs-live-preds",
                          f"{root}/obs-live", *LIVE_SASL, "--stats",
                          "--max-seconds", "600", "--group",
                          "obs-live-score"]}
        t0 = time.perf_counter()
        try:
            for name, args in argv.items():
                procs[name] = subprocess.Popen(
                    [*LIVE_CMD, *args, "--metrics-port", str(ports[name])],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, env=env)
            deadline = time.time() + 300
            while time.time() < deadline:
                for name, port in ports.items():
                    if name not in scrapes["running"]:
                        with contextlib.suppress(OSError):
                            scrapes["running"][name] = _scrape(port)
                trained = backing.committed("obs-live-train", SERVE_TOPIC, 0)
                if len(scrapes["running"]) == 2 and \
                        backing.end_offset("obs-live-preds", 0) \
                        >= LIVE_RECORDS and trained is not None and \
                        LIVE_RECORDS - trained < LIVE_MIN_AVAILABLE:
                    break
                if any(p.poll() is not None for p in procs.values()):
                    break
                time.sleep(0.2)
            time.sleep(1.0)  # the scorer's last stats line and gauges
            for name, port in ports.items():
                scrapes["end"][name] = _scrape(port)
            seconds = time.perf_counter() - t0
            outs = {}
            for name, p in procs.items():
                if p.poll() is None:
                    p.stdin.write("STOP\n")
                    p.stdin.flush()
                outs[name] = p.communicate(timeout=120)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for name, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"obs live {name} exited {p.returncode}:\n"
                                 f"{outs[name][0]}\n{outs[name][1]}")
    if len(scrapes["running"]) != 2:
        raise AssertionError("a live process never answered /metrics")
    lines = {name: [json.loads(line) for line in out.splitlines()
                    if line.startswith("{")]
             for name, (out, _) in outs.items()}
    rounds, drains = lines["train"][-1], lines["score"][-1]
    t_text, t_health = scrapes["end"]["train"]
    s_text, s_health = scrapes["end"]["score"]
    got = {"rounds": _metric(t_text, "live_train_rounds_total"),
           "records_trained": _metric(t_text, "iotml_records_trained_total"),
           "records_scored": _metric(s_text, "iotml_records_scored_total")}
    want = {"rounds": rounds["round"], "records_trained":
            rounds["records_cum"], "records_scored": drains["scored"]}
    if got != want or drains["scored"] != LIVE_RECORDS:
        raise AssertionError(f"scraped {got}, the processes' stats {want}")
    marks = {}
    for name, health, stage in (("train", t_health, "train"),
                                ("score", s_health, "score")):
        wms = health.get("watermarks", {})
        for need in ("consume", stage):
            if not any(k.startswith(f"{need}:{SERVE_TOPIC}:")
                       for k in wms):
                raise AssertionError(f"{name} /healthz lacks the {need} "
                                     f"watermark: {sorted(wms)}")
        if "consume" not in health.get("stages", {}):
            raise AssertionError(f"{name} /healthz lacks stage liveness")
        marks[name] = {"watermarks": sorted(wms),
                       "stages": sorted(health["stages"])}
    return {"scraped": got, "stats": want, "healthz": marks,
            "seconds_to_done": seconds,
            "scrapes_while_running": sorted(scrapes["running"])}


def _obs_captures(root: str, card: str) -> dict:
    """Section 3: profiler windows around one fit, one live round and one
    serve drain of 30,000 rows, each with its busy share and top ops."""
    broker = _obs_broker()
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    source = RowSource.from_fleet(gen, n_ticks=300)
    out = {}
    fit = Trainer(CAR_AUTOENCODER)
    fit._ensure_state()
    batches = SensorBatches(source, batch_size=100, take=100,
                            only_normal=True)
    with obs_profile.trace(f"{root}/prof") as cap:
        fit.fit_compiled(batches, epochs=20)
    out["fit_compiled"] = cap.summary(top=5)
    trainer = ContinuousTrainer(broker, OBS_TOPIC,
                                ArtifactStore(f"{root}/obs-round"),
                                group="obs-round")
    trainer.trainer._ensure_state()
    with obs_profile.trace(f"{root}/prof") as cap:
        trainer.train_round()
    out["live_round"] = cap.summary(top=5)
    scorer = _obs_scorer(broker, fit.state.params, "obs-prof")
    with obs_profile.trace(f"{root}/prof") as cap:
        n = scorer.score_available()
    if n != OBS_ROWS:
        raise AssertionError(f"the profiled drain scored {n}")
    out["serve_drain"] = cap.summary(top=5)
    for name, s in out.items():
        # the union of device intervals inside a synchronized window
        # (1% for the two clocks' skew)
        if not s["device_ops"] or not s["top"] or \
                not 0.0 < s["busy_share"] <= 1.01:
            raise AssertionError(f"capture {name}: {s}")
        s["card"] = card
    return out


def _obs_chaos_scorer(broker, params, device) -> dict:
    eng = obs_faults.arm(obs_faults.ChaosEngine(_fault_events()))
    rewinds = obs_metrics.scorer_rewinds.value()
    try:
        scorer = _obs_scorer(broker, params, f"obs-chaos-{device or 'card'}",
                             device=device)
        scorer.run_forever(poll_interval_s=0.0, max_rounds=3)
    finally:
        obs_faults.disarm()
    written = scorer.out.broker.end_offset(scorer.out.topic, 0)
    committed = broker.committed(scorer.batches.consumer.group, OBS_TOPIC, 0)
    return {"hits": {k: v for k, v in eng.hits.items()
                     if k == "scorer.poll"},
            "injected": dict(eng.injected), "scored": scorer.scored,
            "written": written, "committed": committed,
            "rewinds": obs_metrics.scorer_rewinds.value() - rewinds}


def _fault_events():
    return [obs_faults.FaultEvent(a, p, act, tuple(kw.items()), r)
            for a, p, act, kw, r in OBS_CHAOS]


def _obs_chaos_trainer(broker, root: str, tag: str, faulted: bool,
                       device) -> dict:
    trainer = ContinuousTrainer(broker, OBS_TOPIC, None,
                                group=f"obs-ck-{tag}",
                                registry=ModelRegistry(f"{root}/ck-{tag}"),
                                device=device)
    eng = obs_faults.arm(obs_faults.ChaosEngine(_fault_events())) \
        if faulted else None
    before = fused_train.fused_fit.launches
    try:
        for _ in range(OBS_CHAOS_ROUNDS):
            # one round a call: the writer thread writes and is drained
            # before the next, so the fault lands on the same write
            trainer.run(max_rounds=1, poll_interval_s=0.0)
    finally:
        obs_faults.disarm()
        trainer.close()
    return {"state": trainer.trainer.state,
            "launches": fused_train.fused_fit.launches - before,
            "hits": None if eng is None else
            {k: v for k, v in eng.hits.items()
             if k in ("trainer.poll", "ckpt.write")},
            "injected": None if eng is None else
            {k: v for k, v in eng.injected.items()
             if not k.startswith("scorer")},
            "versions": trainer.registry.versions(),
            "last_error": trainer.checkpointer.last_error,
            "committed": broker.committed(f"obs-ck-{tag}", OBS_TOPIC, 0)}


def _obs_chaos(root: str) -> dict:
    """Section 4: the fault points in-process, on the card and on the CPU
    under the same schedule."""
    broker = _obs_broker()
    params = fresh_state(CAR_AUTOENCODER, "cuda").params
    card = _obs_chaos_scorer(broker, params, None)
    cpu = _obs_chaos_scorer(
        broker, {k: v.cpu() for k, v in params.items()}, "cpu")
    dupes = card["written"] - OBS_ROWS
    if card["rewinds"] != 1 or card["committed"] != OBS_ROWS or \
            card["scored"] != card["written"] or dupes < 0:
        raise AssertionError(f"the faulted scorer: {card}")
    if (card["hits"], card["injected"]) != (cpu["hits"], cpu["injected"]) \
            or card["written"] != cpu["written"]:
        raise AssertionError(f"card {card} and CPU {cpu} fired apart")
    faulted = _obs_chaos_trainer(broker, root, "faulted", True, None)
    clean = _obs_chaos_trainer(broker, root, "clean", False, None)
    cpu_t = _obs_chaos_trainer(broker, root, "cpu", True, "cpu")
    if faulted["launches"] != OBS_CHAOS_ROUNDS or \
            clean["launches"] != OBS_CHAOS_ROUNDS:
        raise AssertionError(f"chaos rounds launched B1 "
                             f"{faulted['launches']} / {clean['launches']}x")
    if (faulted["hits"], faulted["injected"], faulted["versions"]) != \
            (cpu_t["hits"], cpu_t["injected"], cpu_t["versions"]):
        raise AssertionError(f"trainer faults: card {faulted}, CPU {cpu_t}")
    if faulted["last_error"] is None or \
            len(faulted["versions"]) != OBS_CHAOS_ROUNDS - 1 or \
            faulted["committed"] != clean["committed"]:
        raise AssertionError(f"the lost checkpoint: {faulted}")
    err = _lc_states_close("obs_path faulted vs clean", faulted["state"],
                           clean["state"])
    return {"scorer": {"rewinds": card["rewinds"], "duplicates": dupes,
                       "scored": card["scored"],
                       "committed": card["committed"],
                       "hits": card["hits"], "injected": card["injected"]},
            "trainer": {"hits": faulted["hits"],
                        "injected": faulted["injected"],
                        "versions": faulted["versions"],
                        "max_abs_err_vs_clean": err,
                        "tolerance": RESUME_TOL},
            "launches": faulted["launches"] + clean["launches"]}


def _obs_cost() -> dict:
    """Section 5: the serve drain and main_path's fit with tracing off and
    on, in turns (off, on, on, off, twice) within this run."""
    times = {"serve_drain_s": {"off": [], "on": []},
             "fit_s": {"off": [], "on": []}}
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    source = RowSource.from_fleet(gen, n_ticks=300)
    params = fresh_state(CAR_AUTOENCODER, "cuda").params
    obs_tracing.configure(enabled=True)
    broker = _obs_broker()  # every record born traced
    launches = 0
    for k, mode in enumerate(("off", "on", "on", "off") * 2):
        obs_tracing.reset()
        obs_tracing.configure(enabled=mode == "on")
        scorer = _obs_scorer(broker, params, f"obs-cost-{k}")
        t0 = time.perf_counter()
        n = scorer.score_available()
        torch.cuda.synchronize()
        times["serve_drain_s"][mode].append(time.perf_counter() - t0)
        trainer = Trainer(CAR_AUTOENCODER)
        trainer._ensure_state()
        batches = SensorBatches(source, batch_size=100, take=100,
                                only_normal=True)
        before = fused_train.fused_fit.launches
        t0 = time.perf_counter()
        trainer.fit_compiled(batches, epochs=20)
        torch.cuda.synchronize()
        times["fit_s"][mode].append(time.perf_counter() - t0)
        launches += fused_train.fused_fit.launches - before
        if n != OBS_ROWS:
            raise AssertionError(f"cost drain {k} scored {n}")
    obs_tracing.configure(enabled=False)
    obs_tracing.reset()
    return {**times,
            "serve_rows_per_s": {m: [OBS_ROWS / s for s in v]
                                 for m, v in times["serve_drain_s"].items()},
            "launches": launches}


def phase_obs_path(card: str, root: str) -> dict:
    """The observability plane on the card: a traced fit and drain held
    byte for byte against an untraced one; the live CLIs' ``/metrics`` and
    ``/healthz`` against their own stats; profiler captures with busy
    shares; the fault points with the CPU's fire counts; the cost of
    tracing, off and on in turns."""
    reset_launches()
    reset_fit_launches()
    try:
        traced = _obs_traced(root)
        live = _obs_live(root)
        before = fused_train.fused_fit.launches
        captures = _obs_captures(root, card)
        capture_launches = fused_train.fused_fit.launches - before
        chaos = _obs_chaos(root)
        cost = _obs_cost()
    finally:
        obs_tracing.configure(enabled=False, path="")
        obs_tracing.reset()
        obs_faults.disarm()
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    want = 2 + capture_launches + chaos["launches"] + cost["launches"]
    if capture_launches != 2 or launches != want or \
            by_design["rows"] != launches:
        raise AssertionError(f"obs_path launched B1 {launches}x "
                             f"({by_design}), want {want} with 2 in the "
                             f"captures")
    attention = {k: v for k, v in path_launches().items() if k != "fused_fit"}
    if any(attention.values()):
        raise AssertionError(f"obs_path launched {attention}")
    info = {"phase": "obs_path", "card": card, "traced": traced,
            "live": live, "captures": captures, "chaos": chaos,
            "cost": cost, "kernel_launches": launches}
    emit(info)
    return {"launches": launches, "counts": attention,
            "launches_by_design": by_design}


#: the telemetry path's live run: TELE_FEEDS feeds of 23 fleet ticks (2,300
#: records: one default round of 20 x 100 normal rows each) into the live
#: topic, one every TELE_FEED_S seconds, the plane scraping the two
#: processes (attached) or not in turns
TELE_FEEDS, TELE_FEED_TICKS, TELE_FEED_S = 10, 23, 1.5
TELE_MODES = ("off", "on", "on", "off", "off", "on", "on", "off", "off",
              "on")
#: the plane's scrape cadence while attached, and its TSDB chunk window
TELE_SCRAPE_S, TELE_CHUNK_MS = 0.25, 5_000
TELE_TOPIC, TELE_PREDS = "telemetry-live", "telemetry-preds"
TELE_PROCS = {"train": "telemetry-train", "score": "telemetry-score"}
#: the SRE workbook's window pairs compressed to the run's length
TELE_WINDOWS = (("fast", 10_000, 30_000, 14.4),
                ("slow", 20_000, 60_000, 6.0))
#: the rules of the healthy run: the train loop's step latency (good =
#: under 5 s) and its progress (records lost to an offset auto-reset
#: against records trained)
TELE_SLO_RULES = (
    {"name": "train-step-latency", "objective": 0.99,
     "indicator": {"kind": "latency", "metric": "iotml_step_seconds",
                   "threshold_s": 5.0, "matchers": {"loop": "train"}},
     "windows": TELE_WINDOWS},
    {"name": "train-progress", "objective": 0.999,
     "indicator": {"kind": "ratio",
                   "bad": "iotml_consumer_autoresets_total",
                   "total": "iotml_records_trained_total",
                   "matchers": {"process": TELE_PROCS["train"]}},
     "windows": TELE_WINDOWS})
#: a live CLI as a process that prints its own B1 launch counts at exit
TELE_CHILD = (
    "import atexit, json, sys\n"
    "from iotml_torch.ops import fused_train as f\n"
    "atexit.register(lambda: print(json.dumps({'fit_launches': "
    "f.fused_fit.launches, 'fit_launches_by_design': "
    "dict(f.fused_fit.launches_by_design)}), flush=True))\n"
    "from iotml_torch.cli import live\n"
    "sys.exit(live.main(sys.argv[1:]))\n")


class _KeptCollector(obs_federate.FleetCollector):
    """A fleet collector that keeps every ``/metrics`` text it scraped,
    beside the stamp its samples went into the TSDB under."""

    def __init__(self, endpoints, manifest):
        super().__init__(endpoints=endpoints, manifest=manifest)
        self.kept = []
        self._texts = {}

    def _get(self, address, path):
        text = super()._get(address, path)
        if path == "/metrics" and text is not None:
            self._texts[address] = text
        return text

    def collect(self):
        self._texts = {}
        snaps = super().collect()
        for name, s in snaps.items():
            if s["up"]:
                self.kept.append((name, int(s["ts"] * 1000),
                                  self._texts[s["address"]]))
        return snaps


_PROM_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _plain_samples(text: str, name: str) -> list:
    """``(labels, value)`` of family sample ``name`` in a Prometheus text,
    read with two regular expressions (independent of ``federate``)."""
    out = []
    for line in text.splitlines():
        m = _PROM_LINE.match(line)
        if m and m.group(1) == name:
            out.append((dict(_PROM_LABEL.findall(m.group(2) or "")),
                        float(m.group(3))))
    return out


def _plain_series(kept, proc: str, name: str, labels: dict) -> list:
    """One series' ``(ts_ms, value)`` from the kept texts, as the appender
    keeps it: ascending stamps, a repeated stamp overwriting."""
    pts = []
    for p, ts, text in kept:
        if p != proc:
            continue
        for lab, v in _plain_samples(text, name):
            if lab == labels:
                if pts and pts[-1][0] == ts:
                    pts[-1] = (ts, v)
                elif not pts or ts > pts[-1][0]:
                    pts.append((ts, v))
    return pts


def _plain_rate(pts, window_ms: int, at_ms: int) -> float:
    win = [(t, v) for t, v in pts if at_ms - window_ms <= t <= at_ms]
    inc = 0.0
    for (_t0, v0), (_t1, v1) in zip(win, win[1:]):
        inc += v1 - v0 if v1 >= v0 else v1
    return inc / ((win[-1][0] - win[0][0]) / 1000.0)


def _plain_quantile(q: float, buckets) -> float:
    """Prometheus interpolation over ``[(edge, cumulative count)]``."""
    buckets = sorted(buckets)
    rank = q * buckets[-1][1]
    prev_edge = prev_count = 0.0
    for edge, count in buckets:
        if count >= rank:
            if edge == math.inf:
                return prev_edge
            span = count - prev_count
            frac = (rank - prev_count) / span if span > 0 else 0.0
            return prev_edge + (edge - prev_edge) * frac
        prev_edge, prev_count = edge, count
    raise AssertionError("no bucket reached the rank")


def _tele_recompute(kept, series, at_ms: int) -> dict:
    """The TSDB's answers for the train process against the same numbers
    recomputed from the kept texts."""
    proc = TELE_PROCS["train"]
    pts = _plain_series(kept, proc, "iotml_records_trained_total", {})
    got_rate = obs_tsdb.query(
        series, f'rate(iotml_records_trained_total{{process="{proc}"}}'
        f'[20s])', at_ms=at_ms)
    want_rate = _plain_rate(pts, 20_000, at_ms)
    got_q = obs_tsdb.query(
        series, f'histogram_quantile(0.99, iotml_step_seconds'
        f'{{loop="train",process="{proc}"}})', at_ms=at_ms)
    want_q = {}
    last = [text for p, _ts, text in kept if p == proc][-1]
    for phase in ("device_compute", "host_pipeline"):
        buckets = [(float(lab["le"]), v) for lab, v in
                   _plain_samples(last, "iotml_step_seconds_bucket")
                   if lab.get("loop") == "train"
                   and lab.get("phase") == phase]
        want_q[phase] = _plain_quantile(0.99, buckets)
    got_q = {r["labels"]["phase"]: r["value"] for r in got_q}
    if len(got_rate) != 1 or got_q.keys() != want_q.keys():
        raise AssertionError(f"TSDB answers {got_rate} / {got_q}")
    errs = [abs(got_rate[0]["value"] - want_rate) / abs(want_rate)] + \
        [abs(got_q[k] - want_q[k]) / abs(want_q[k]) for k in want_q]
    if max(errs) > 1e-12 or want_rate <= 0:
        raise AssertionError(f"TSDB rate {got_rate[0]['value']} / "
                             f"quantiles {got_q} against the recompute "
                             f"{want_rate} / {want_q}")
    return {"rate_records_trained_per_s": want_rate,
            "p99_step_seconds": want_q, "max_rel_diff": max(errs),
            "tolerance_rel": 1e-12, "samples_in_rate": len(pts)}


def _tele_live(root: str) -> dict:
    """(a) The plane over both live CLIs on the card: the scrape into a
    TSDB on a durable broker, a supervised SLO engine, the checks and the
    per-round cost with the plane attached and not."""
    d = Path(root) / "telemetry"
    d.mkdir(parents=True, exist_ok=True)
    manifest = str(d / "endpoints.json")
    backing = Broker()
    backing.create_topic(TELE_TOPIC)
    backing.create_topic(TELE_PREDS)
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    tele = Broker(store_dir=str(d / "store"))
    appender = obs_tsdb.TsdbAppender(tele, chunk_ms=TELE_CHUNK_MS)
    ports = {k: _free_port() for k in TELE_PROCS}
    procs, outs = {}, {}
    sup = fleet = None
    plane_stop, attached = threading.Event(), threading.Event()
    scrapes, fired = [], []
    modes = []
    with _wire_server(backing) as servers:
        argv = {"train": ["train", servers, TELE_TOPIC, str(d / "store-m"),
                          *LIVE_SASL, "--stats", "--max-seconds", "600",
                          "--group", "telemetry-train"],
                "score": ["score", servers, TELE_TOPIC, TELE_PREDS,
                          str(d / "store-m"), *LIVE_SASL, "--stats",
                          "--max-seconds", "600", "--group",
                          "telemetry-score"]}
        try:
            for name, args in argv.items():
                env = {**os.environ, "IOTML_OBS_ENDPOINTS": manifest,
                       "IOTML_PROC": TELE_PROCS[name]}
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", TELE_CHILD, *args,
                     "--metrics-port", str(ports[name])],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, env=env)
            deadline = time.time() + 180
            while len(obs_federate.load_manifest(manifest)) < 2:
                dead = {n: p.communicate() for n, p in procs.items()
                        if p.poll() is not None}
                if dead or time.time() > deadline:
                    raise AssertionError(f"the live processes never "
                                         f"published their endpoints: "
                                         f"{dead}")
                time.sleep(0.1)
            collector = _KeptCollector(obs_federate.load_manifest(manifest),
                                       manifest)
            fleet = obs_federate.FleetServer(collector, port=0,
                                             broker=tele, tsdb=appender)
            threading.Thread(target=fleet.srv.serve_forever, daemon=True,
                             name="telemetry-fleet-http").start()
            engine = obs_slo.SloEngine(tele, TELE_SLO_RULES, interval_s=0.5)
            sup = Supervisor(poll_interval_s=0.05, name="telemetry-sup")
            unit = sup.add_loop("slo-engine", engine.loop,
                                heartbeat_timeout_s=30.0)
            sup.start()

            def plane():
                while not plane_stop.is_set():
                    if attached.is_set():
                        n0 = obs_tsdb.tsdb_appends.value()
                        t0 = time.perf_counter()
                        fleet.scrape_once()
                        scrapes.append((time.perf_counter() - t0,
                                        obs_tsdb.tsdb_appends.value() - n0))
                    if obs_slo.firing_alerts():
                        fired.append(obs_slo.firing_alerts())
                    plane_stop.wait(TELE_SCRAPE_S)

            plane_thread = threading.Thread(target=plane, daemon=True,
                                            name="telemetry-plane")
            plane_thread.start()
            # both processes answer before the first feed (every scrape
            # goes through the TSDB: the kept texts are what it holds)
            while sum(1 for s in fleet.scrape_once().values()
                      if s["up"]) < 2:
                if time.time() > deadline:
                    raise AssertionError("the live processes never "
                                         "answered a scrape")
                time.sleep(0.2)
            for mode in TELE_MODES:
                (attached.set if mode == "on" else attached.clear)()
                t0 = time.time()
                gen.publish(backing, TELE_TOPIC, n_ticks=TELE_FEED_TICKS)
                time.sleep(TELE_FEED_S)
                modes.append((t0, time.time(), mode))
            attached.set()
            end = backing.end_offset(TELE_TOPIC, 0)
            deadline = time.time() + 120
            while time.time() < deadline:
                trained = backing.committed("telemetry-train", TELE_TOPIC, 0)
                if backing.end_offset(TELE_PREDS, 0) >= end and \
                        trained is not None and \
                        end - trained < LIVE_MIN_AVAILABLE:
                    break
                time.sleep(0.2)
            time.sleep(1.0)  # the last round's counters, one more scrape
            attached.clear()
            plane_stop.set()
            plane_thread.join()
            final = fleet.scrape_once()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{fleet.port}/healthz", timeout=10) as r:
                fleet_health = json.loads(r.read())
            merged = collector.render(final)
            for name, p in procs.items():
                p.stdin.write("STOP\n")
                p.stdin.flush()
                outs[name] = p.communicate(timeout=120)
        finally:
            plane_stop.set()
            if sup is not None:
                sup.stop()
            if fleet is not None:
                fleet.stop()
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for name, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"telemetry {name} exited {p.returncode}:"
                                 f"\n{outs[name][0]}\n{outs[name][1]}")
    lines = {name: [json.loads(line) for line in out.splitlines()
                    if line.startswith("{")]
             for name, (out, _) in outs.items()}
    launch = {name: [x for x in ls if "fit_launches" in x][-1]
              for name, ls in lines.items()}
    rounds = [x for x in lines["train"] if "round" in x]
    drains = [x for x in lines["score"] if "scored" in x]
    # checks: the fleet, the TSDB against the texts, the stats, compaction
    up = sum(v for _l, v in _plain_samples(merged, "iotml_cluster_up"))
    if up != 2 or fleet_health["up_count"] != 2 or \
            fleet_health["status"] != "ok":
        raise AssertionError(f"iotml_cluster_up {up}, fleet {fleet_health}")
    series = obs_tsdb.read_series(tele)
    at_ms = max(ts for p, ts, _ in collector.kept
                if p == TELE_PROCS["train"])
    recompute = _tele_recompute(collector.kept, series, at_ms)
    trained = obs_tsdb.query(
        series, f'iotml_records_trained_total{{process='
        f'"{TELE_PROCS["train"]}"}}', at_ms=at_ms)
    scored = obs_tsdb.query(
        series, f'iotml_records_scored_total{{process='
        f'"{TELE_PROCS["score"]}"}}', at_ms=at_ms)
    if len(rounds) < 5 or trained[0]["value"] != rounds[-1]["records_cum"] \
            or scored[0]["value"] != drains[-1]["scored"]:
        raise AssertionError(f"{len(rounds)} rounds; TSDB trained "
                             f"{trained}, scored {scored}; stats "
                             f"{rounds[-1:]} {drains[-1:]}")
    if launch["train"]["fit_launches"] != len(rounds) or \
            launch["train"]["fit_launches_by_design"]["rows"] != \
            len(rounds) or launch["score"]["fit_launches"] != 0:
        raise AssertionError(f"B1 launches {launch} for {len(rounds)} "
                             f"rounds")
    if fired or obs_slo.read_alerts(tele) or \
            any(st.firing for st in engine.states.values()) or \
            unit.restarts:
        raise AssertionError(f"an alert on the healthy run: {fired}, "
                             f"{obs_slo.read_alerts(tele)}")
    timings = {
        "read_series_ms": _median_ms(lambda: obs_tsdb.read_series(tele), 5),
        "rate_query_ms": _median_ms(lambda: obs_tsdb.query(
            series, "rate(iotml_records_trained_total[20s])", at_ms=at_ms),
            5),
        "histogram_quantile_ms": _median_ms(lambda: obs_tsdb.query(
            series, 'histogram_quantile(0.99, iotml_step_seconds'
            '{loop="train"})', at_ms=at_ms), 5),
        "slo_evaluation_ms": _median_ms(
            lambda: engine.evaluate(now_ms=at_ms), 5)}
    pre = obs_drill._count_records(tele, obs_tsdb.TSDB_TOPIC)
    keys = len(obs_drill._read_tsdb_keys(tele))
    tele.store.log_for(obs_tsdb.TSDB_TOPIC, 0).roll()
    tele.run_compaction(force=True)
    post = obs_drill._count_records(tele, obs_tsdb.TSDB_TOPIC)
    if not 0 < post == keys < pre:
        raise AssertionError(f"_IOTML_TSDB {pre} -> {post} records after "
                             f"compaction, {keys} (series, window) keys")
    tele.close()
    by_mode = {"on": [], "off": []}
    for r in rounds:
        for t0, t1, mode in modes:
            if t0 <= r["t"] - r["seconds"] and r["t"] <= t1:
                by_mode[mode].append(r["seconds"])
    on_scrapes = [s for s in scrapes if s[1]]
    return {"rounds": len(rounds), "fit_launches": launch["train"],
            "records_trained": rounds[-1]["records_cum"],
            "scored": drains[-1]["scored"], "cluster_up": up,
            "recompute": recompute, "kept_texts": len(collector.kept),
            "tsdb_records_before_compaction": pre,
            "tsdb_records_after_compaction": post, "tsdb_keys": keys,
            "scrape_append_ms": [s * 1e3 for s, _n in on_scrapes],
            "scrape_append_ms_median": float(np.median(
                [s for s, _n in on_scrapes])) * 1e3,
            "scrape_append_records": [n for _s, n in on_scrapes],
            **timings,
            "round_seconds_plane_on": by_mode["on"],
            "round_seconds_plane_off": by_mode["off"],
            "history": {"loss": [r["loss"] for r in rounds],
                        "seconds": [r["seconds"] for r in rounds]}}


def _wake_lateness(stop: threading.Event, late: list,
                   period_s: float = 0.01) -> None:
    """How late a thread that sleeps ``period_s`` at a time wakes: the
    host's CPU contention, which the drill's canaries feel too."""
    while not stop.is_set():
        t = time.perf_counter()
        time.sleep(period_s)
        late.append(time.perf_counter() - t - period_s)


def _tele_drill() -> dict:
    """(b) The alert-burn drill at its defaults through its CLI,
    ``python -m iotml_torch.obs tsdb drill --json``, in a process of its
    own, as users run it, its scorer on the card.  In this process, after
    the earlier phases, its healthy phase paged: its canaries' round trips
    sit close to their 0.1 s latency SLO, and with the heap and state the
    earlier phases leave behind more of them crossed it.  On a host whose
    8 cores 12 to 16 other busy processes share, 10-50% of them cross it
    and the healthy phase pages: the wake-up lateness measured here while
    the drill runs, printed with its verdict, tells that case apart."""
    stop, late = threading.Event(), []
    sampler = threading.Thread(target=_wake_lateness, args=(stop, late),
                               daemon=True, name="wake-lateness")
    sampler.start()
    try:
        out = subprocess.run(
            [sys.executable, "-m", "iotml_torch.obs", "tsdb", "drill",
             "--json"], capture_output=True, text=True, timeout=300)
    finally:
        stop.set()
        sampler.join()
    late.sort()
    lateness = {"samples": len(late),
                "p50_ms": late[len(late) // 2] * 1e3,
                "p90_ms": late[int(len(late) * 0.9)] * 1e3,
                "max_ms": late[-1] * 1e3,
                "over_20ms": sum(x > 0.02 for x in late)}
    try:
        rep = json.loads(out.stdout[out.stdout.index("{"):])
    except ValueError:
        raise AssertionError(f"alert-burn drill exited {out.returncode}: "
                             f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    inv = {i["name"]: i for i in rep["invariants"]}
    if out.returncode != 0 or not rep["ok"]:
        raise AssertionError(
            "alert-burn drill:\n" + "\n".join(
                f"{'PASS' if i['ok'] else 'FAIL'}  {n}: {i['detail']}"
                for n, i in inv.items())
            + f"\nwake-up lateness of a 10 ms sleep here meanwhile: "
            f"{lateness}")
    need = {"alert_fired_fast_within_budget", "alert_in_changelog",
            "alert_in_healthz", "alert_resolved", "resolve_in_changelog",
            "zero_canaries_scored", "tsdb_bounded_after_compaction"}
    if not need <= set(inv):
        raise AssertionError(f"drill invariants {sorted(inv)}")
    return {"ok": True, "slos": rep["slos"], "scored": rep["scored"],
            "published": rep["published"], "injected": rep["injected"],
            "invariants": {n: i["detail"] for n, i in inv.items()},
            "wake_lateness": lateness}


def _tele_platform(root: str, history: dict) -> dict:
    """(c) The control center over a platform one fleet tick old, the
    dashboard over every family, the live fit's history as scalars."""
    plat = Platform(cc_port=0).start(metrics_port=0)
    try:
        plat.start_fleet(20, rate_hz=5.0)
        time.sleep(0.5)
        plat.stop_fleet()
        bridged = plat.drain_ingest()
        col = obs_federate.FleetCollector(endpoints=[{
            "name": "platform", "address":
            f"127.0.0.1:{plat.metrics_server.server_address[1]}"}])
        if not col.collect()["platform"]["up"]:
            raise AssertionError("the platform's /metrics did not answer")
        with urllib.request.urlopen(plat.endpoints()["control-center"]
                                    + "/api/status", timeout=10) as r:
            status = json.loads(r.read())
        want = {}
        for name in plat.broker.topics():
            n = plat.broker.topic(name).partitions
            end = sum(plat.broker.end_offset(name, q) for q in range(n))
            begin = sum(plat.broker.begin_offset(name, q) for q in range(n))
            want[name] = {"name": name, "partitions": n,
                          "messages": end - begin, "end_offset": end}
        got = {t["name"]: t for t in status["topics"]}
        if got != want or bridged <= 0 or \
                want["SENSOR_DATA_S_AVRO"]["messages"] != bridged:
            raise AssertionError(f"/api/status topics {got}, the broker "
                                 f"{want}, {bridged} bridged")
    finally:
        plat.stop()
    logger = ScalarLogger(str(Path(root) / "telemetry-scalars"),
                          use_tensorboard=False)
    logger.history(history, prefix="live")
    logger.close()
    with open(Path(root) / "telemetry-scalars" / "scalars.jsonl") as fh:
        back = [json.loads(line) for line in fh]
    read = {"loss": [x["value"] for x in back if x["tag"] == "live/loss"],
            "seconds": [x["value"] for x in back
                        if x["tag"] == "live/epoch_seconds"]}
    if read != history:
        raise AssertionError(f"scalars read back {read}, wrote {history}")
    dash = obs_dashboards.generate_dashboard()
    exprs = " ".join(t["expr"] for p in dash["panels"] for t in p["targets"])
    families = sorted(obs_metrics.default_registry._metrics)
    missing = [f for f in families if f not in exprs]
    if missing or len(dash["panels"]) != len(families):
        raise AssertionError(f"dashboard lacks {missing}")
    return {"topics": len(got), "bridged": bridged,
            "topic_offsets_equal_broker": True,
            "dashboard_panels": len(dash["panels"]),
            "families": len(families), "scalars": len(back)}


def phase_telemetry_path(card: str, root: str) -> dict:
    """The telemetry plane watching B1's live rounds on the card: (a) the
    federated scrape of both live CLIs into ``_IOTML_TSDB`` on a durable
    broker under a supervised SLO engine, held against a recompute from
    the kept texts, the processes' stats and their own B1 counts; (b) the
    alert-burn drill; (c) the control center, dashboards and scalar
    logs."""
    reset_launches()
    reset_fit_launches()
    t0 = time.perf_counter()
    live = _tele_live(root)
    t1 = time.perf_counter()
    drill = _tele_drill()
    t2 = time.perf_counter()
    plat = _tele_platform(root, live["history"])
    counts = path_launches()
    if any(counts.values()):
        raise AssertionError(f"telemetry_path launched {counts} in-process")
    info = {"phase": "telemetry_path", "card": card, "live": live,
            "drill": drill, "platform": plat,
            "seconds": {"live": t1 - t0, "drill": t2 - t1,
                        "platform": time.perf_counter() - t2},
            "kernel_launches": live["fit_launches"]}
    emit(info)
    return {"launches": live["fit_launches"]["fit_launches"],
            "launches_by_design": live["fit_launches"]
            ["fit_launches_by_design"],
            "counts": {k: v for k, v in counts.items() if k != "fused_fit"}}


#: the KSQL stage's fleet: one tick of the reference's 100,000 cars
#: (reference README.md:19), JSON on a 4-partition sensor-data (the demo
#: platform's partition count), keyed as the MQTT bridge keys it
KSQL_CARS = 100_000
KSQL_PARTITIONS = 4
KSQL_TOPICS = ("SENSOR_DATA_S_AVRO", "SENSOR_DATA_S_AVRO_REKEY",
               "SENSOR_DATA_EVENTS_PER_5MIN_T")
#: records of each leg held against the pure Python leg
KSQL_PLAIN_ROWS = 2_000


def _ksql_http(server, method: str, path: str, body=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _bridge_key(scenario, car: int) -> bytes:
    """The MQTT bridge's record key: the car's MQTT topic."""
    return f"vehicles/sensor/data/{scenario.car_id(car)}".encode()


def _ksql_fleet_json(broker) -> float:
    """One tick of the fleet as the platform's fleet writes it
    (``json.dumps(gen.row_record(cols, i, KSQL_CAR_SCHEMA))``), produced
    to sensor-data under the bridge's keys; returns the seconds."""
    t0 = time.perf_counter()
    scenario = FleetScenario(num_cars=KSQL_CARS, failure_rate=0.01)
    gen = FleetGenerator(scenario)
    cols = gen.step_columns()
    ts = int(gen.t * 1000)
    broker.produce_many("sensor-data", [
        (_bridge_key(scenario, i),
         json.dumps(gen.row_record(cols, i, KSQL_CAR_SCHEMA)).encode(), ts)
        for i in range(KSQL_CARS)])
    return time.perf_counter() - t0


def _ksql_straight_avro() -> Broker:
    """The same generator rows published straight as framed Avro by the
    generator's encoder (``FleetGenerator.publish``'s), under the same
    keys and partitions: what main_path's kind of publishing gives."""
    scenario = FleetScenario(num_cars=KSQL_CARS, failure_rate=0.01)
    gen = FleetGenerator(scenario)
    cols = gen.step_columns()
    msgs = native.NativeCodec(KSQL_CAR_SCHEMA).encode_batch(
        gen.sensor_matrix(cols),
        cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
    broker = Broker()
    broker.create_topic("SENSOR_DATA_S_AVRO", partitions=KSQL_PARTITIONS)
    broker.produce_many("SENSOR_DATA_S_AVRO", [
        (_bridge_key(scenario, i), m, int(gen.t * 1000))
        for i, m in enumerate(msgs)])
    return broker


def _ksql_batches(broker, group: str):
    specs = [f"SENSOR_DATA_S_AVRO:{p}:0" for p in range(KSQL_PARTITIONS)]
    return list(next(SensorBatches(
        StreamConsumer(broker, specs, group=group), batch_size=100,
        take=100, only_normal=True).epochs(1)))


def _ksql_timed_legs(engine) -> dict:
    """Wrap each persistent query's ``process_available`` to add up its
    seconds and records; returns {sink: [seconds, records]}."""
    legs = {}
    for q in engine.queries.values():
        real = q.task.process_available
        slot = legs.setdefault(q.sink, [0.0, 0])

        def timed(chunk=4096, real=real, slot=slot):
            t0 = time.perf_counter()
            n = real(chunk)
            slot[0] += time.perf_counter() - t0
            slot[1] += n
            return n

        q.task.process_available = timed
    return legs


def _ksql_plain_legs(broker, engine) -> dict:
    """The first KSQL_PLAIN_ROWS records of each leg (an equal share of
    each partition) against the port's pure Python leg, called by name
    (``process_plain``): the AVRO and REKEY values byte for byte in
    order, the CTAS rows against the table topic's row for each key."""
    tasks = {q.sink: q.task for q in engine.queries.values()}
    per = KSQL_PLAIN_ROWS // KSQL_PARTITIONS
    checked = {}
    for src, sink in (("sensor-data", "SENSOR_DATA_S_AVRO"),
                      ("SENSOR_DATA_S_AVRO", "SENSOR_DATA_S_AVRO_REKEY")):
        n = 0
        for p in range(KSQL_PARTITIONS):
            msgs = broker.fetch(src, p, 0, per)
            plain = tasks[sink].process_plain(msgs)
            got = [(m.key, m.value, m.timestamp_ms)
                   for m in broker.fetch(sink, p, 0, per)]
            if plain != got:
                bad = next(i for i, (a, b) in enumerate(zip(plain, got))
                           if a != b) if len(plain) == len(got) else None
                raise AssertionError(f"ksql_path: {sink} partition {p} "
                                     f"differs from the Python leg (first "
                                     f"at {bad}, {len(plain)} vs "
                                     f"{len(got)} records)")
            n += len(got)
        checked[sink] = n
    table_topic = "SENSOR_DATA_EVENTS_PER_5MIN_T"
    rows = {m.key: m.value
            for p in range(KSQL_PARTITIONS)
            for m in broker.fetch(table_topic, p, 0, KSQL_CARS)}
    msgs = [m for p in range(KSQL_PARTITIONS)
            for m in broker.fetch("SENSOR_DATA_S_AVRO_REKEY", p, 0, per)]
    plain = tasks[table_topic].process_plain(msgs)
    if len(plain) != len(msgs) or any(rows.get(k) != v for k, v, _ in plain):
        raise AssertionError("ksql_path: CTAS rows differ from the Python "
                             "leg's")
    checked[table_topic] = len(plain)
    return checked


def _ksql_stage(store_dir=None) -> dict:
    """The platform's KSQL stage on loopback: the reference DDL posted
    over HTTP, the fleet's JSON pumped through every leg, each check of
    the stage; returns the broker, the registry's id and the timings.
    ``store_dir`` puts it on a durable broker, where the JSON→AVRO leg
    takes its raw produce leg (``SqlSelectTask.process_raw``), as JAX's
    does: the leg's records a RAW_PRODUCE batch are counted."""
    broker = Broker(store_dir=store_dir)
    broker.create_topic("sensor-data", partitions=KSQL_PARTITIONS)
    broker.create_topic("model-predictions", partitions=KSQL_PARTITIONS)
    registry = SchemaRegistry()
    registry.register(subject_for_topic("sensor-data"),
                      CAR_SCHEMA.avro_json())
    registry.register(subject_for_topic("SENSOR_DATA_S_AVRO"),
                      KSQL_CAR_SCHEMA.avro_json())
    reg_srv = SchemaRegistryServer(registry).start()
    wire = KafkaWireServer(broker).start()
    owner = broker.restrict_topic("SENSOR_DATA_S_AVRO")
    engine = SqlEngine(broker, registry=registry, trusted_passthrough=True,
                       owner_token=owner, passthrough_sample=32)
    # the pump thread sleeps an hour between rounds: pump_now drives them
    ksql = KsqlServer(engine, pump_interval_s=3600.0).start()
    try:
        status, ddl = _ksql_http(ksql, "POST", "/ksql",
                                 {"ksql": REFERENCE_PIPELINE_DDL})
        if status != 200 or len(ddl) != 4 or any(
                r.get("commandStatus", {}).get("status") != "SUCCESS"
                for r in ddl):
            raise AssertionError(f"ksql_path: the DDL answered {status}: "
                                 f"{ddl}")
        publish_s = _ksql_fleet_json(broker)
        legs = _ksql_timed_legs(engine)
        native.reset_stats()
        raw0 = raw_produce_records.value()
        rounds = []
        t0 = time.perf_counter()
        while True:
            n = ksql.pump_now()
            rounds.append(n)
            if n == 0:
                break
        pump_s = time.perf_counter() - t0
        raw_records = raw_produce_records.value() - raw0
        frame_encode = {k: native.stats[k] for k in ("frame_encode_rows",
                                                     "frame_encode_s")}
        fallback = {k: v for k, v in native.stats.items()
                    if k.endswith("_fallback_rows")}
        json_rows = native.stats["json_decode_rows"]
        counts = {t: sum(broker.end_offset(t, p)
                         for p in range(broker.topic(t).partitions))
                  for t in KSQL_TOPICS}
        if counts["SENSOR_DATA_S_AVRO"] != KSQL_CARS or \
                counts["SENSOR_DATA_S_AVRO_REKEY"] != KSQL_CARS:
            raise AssertionError(f"ksql_path: legs hold {counts}")
        table = engine.table("SENSOR_DATA_EVENTS_PER_5MIN_T")
        if len(table) != KSQL_CARS or \
                {v["EVENT_COUNT"] for v in table.values()} != {1}:
            raise AssertionError(f"ksql_path: the CTAS table holds "
                                 f"{len(table)} keys")
        queries = engine.execute("SHOW QUERIES")[0]["queries"]
        if len(queries) != 3 or any(q["state"] != "RUNNING" or "error" in q
                                    for q in queries):
            raise AssertionError(f"ksql_path: SHOW QUERIES {queries}")
        status, subjects = _ksql_http(reg_srv, "GET", "/subjects")
        want_subjects = {"SENSOR_DATA_S_AVRO-value",
                         "SENSOR_DATA_S_AVRO_REKEY-value"}
        if status != 200 or not want_subjects <= set(subjects):
            raise AssertionError(f"ksql_path: GET /subjects {subjects}")
        sid = registry.latest("SENSOR_DATA_S_AVRO-value").schema_id
        header = b"\x00" + sid.to_bytes(4, "big")
        frames = {m.value[:5] for p in range(KSQL_PARTITIONS)
                  for m in broker.fetch("SENSOR_DATA_S_AVRO", p, 0,
                                        KSQL_CARS)}
        if frames != {header}:
            raise AssertionError(f"ksql_path: frame headers {frames}, "
                                 f"want id {sid}")
        plain = _ksql_plain_legs(broker, engine)
        # an external producer on the wire may not write the AVRO leg
        ends = [broker.end_offset("SENSOR_DATA_S_AVRO", p)
                for p in range(KSQL_PARTITIONS)]
        client = KafkaWireBroker(f"127.0.0.1:{wire.port}")
        try:
            client.produce("SENSOR_DATA_S_AVRO", b"external",
                           key=b"vehicles/sensor/data/x")
            refused = False
        except PermissionError:
            refused = True
        finally:
            client.close()
        if not refused or ends != [broker.end_offset("SENSOR_DATA_S_AVRO",
                                                     p)
                                   for p in range(KSQL_PARTITIONS)]:
            raise AssertionError("ksql_path: a wire produce to "
                                 "SENSOR_DATA_S_AVRO was not refused with "
                                 "error 29, or moved the end offsets")
    finally:
        ksql.stop()
        reg_srv.stop()
        wire.shutdown()
        wire.server_close()
    rates = {sink: {"records": n, "seconds": s,
                    "records_per_s": n / s if s else None}
             for sink, (s, n) in legs.items()}
    return {"broker": broker, "schema_id": sid, "publish_s": publish_s,
            "pump_s": pump_s, "pump_rounds": rounds, "legs": rates,
            "fallback_rows": fallback, "json_decode_rows": json_rows,
            "plain_checked": plain, "subjects": subjects,
            "wire_produce_refused": refused,
            "raw_produce_records": raw_records,
            "frame_encode": frame_encode}


def _recompute_ksql(broker, params):
    """The CPU forward of SENSOR_DATA_S_AVRO's rows in the scorer's
    consumer order."""
    specs = [f"SENSOR_DATA_S_AVRO:{p}:0" for p in range(KSQL_PARTITIONS)]
    batches = SensorBatches(StreamConsumer(broker, specs), batch_size=100)
    x = torch.from_numpy(np.concatenate([b.x[:b.n_valid] for b in batches]))
    with torch.no_grad():
        return torch.func.functional_call(CAR_AUTOENCODER.build("cpu"),
                                          params, (x,)).numpy(), x.numpy()


def _fit_and_score(broker, bs, where: str,
                   bound_orders: int = 0) -> dict:
    """The slice's device work on SENSOR_DATA_S_AVRO's batches ``bs`` (100
    of 100 normal rows): ``fit_compiled`` for 20 epochs on the card (one
    B1 launch through rows: the fit counts must be 0 just before) held
    against ``fused_fit_reference`` at the fit bounds and timed again
    alone; the threshold at the 99th percentile of 512 normal rows'
    errors (the demo's); the scorer over all KSQL_CARS rows into
    ``model-predictions`` against a CPU recompute (first 100 at atol
    2e-6, all at 1e-5).  With ``bound_orders`` the params are held
    instead to the float64 fit of the same rows within the float32 order
    noise of the plain version on that many orders of them
    (``order_noise_bound``, derived before the gate); losses,
    accuracies and moments stay at the fit bounds."""
    trainer = Trainer(CAR_AUTOENCODER)  # the card
    trainer._ensure_state()
    before = _clone_state(trainer.state)
    t0 = time.perf_counter()
    hist = trainer.fit_compiled(bs, epochs=20)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if launches != 1 or by_design["rows"] != 1:
        raise AssertionError(f"{where} launched the fit kernel "
                             f"{launches}x ({by_design}), not once through "
                             f"rows")
    xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
    p_state, p_loss, p_acc = fused_train.fused_fit_reference(
        before, xs, masks, 20)
    bound = drift = None
    if bound_orders:
        rows = np.concatenate([b.x for b in bs])
        bound = order_noise_bound(before, row_orders(rows, bound_orders),
                                  masks)
    err = check_fit(where, (trainer.state, torch.tensor(hist["loss"]),
                            torch.tensor(hist["accuracy"])),
                    (p_state, p_loss.cpu(), p_acc.cpu()), 100 * 20,
                    parts=("mu", "nu") if bound else
                    ("params", "mu", "nu"))
    if bound:
        drift = params_drift(trainer.state.params, p_state.params,
                             bound["float64"][0])
        if not within_bound(drift["kernel_vs_float64"], bound):
            raise AssertionError(f"{where} params: farther from the float64 "
                                 f"fit than float32 order noise "
                                 f"{public_bound(bound)}: {drift}")
    kernel_ms = cuda_ms(lambda: fused_train.fused_fit(before, xs, masks, 20),
                        reps=5)

    # threshold: the 99th percentile of training rows' errors, as the
    # demo takes it (512 normal rows from the start of the topic)
    specs = [f"SENSOR_DATA_S_AVRO:{p}:0" for p in range(KSQL_PARTITIONS)]
    sample = next(iter(SensorBatches(
        StreamConsumer(broker, specs, group=f"{where}-threshold"),
        batch_size=512, only_normal=True)))
    threshold = float(np.percentile(anomaly.reconstruction_errors(
        CAR_AUTOENCODER, trainer.state.params,
        sample.x[:sample.n_valid]), 99.0))
    scorer = StreamScorer(
        CAR_AUTOENCODER, trainer.state.params,
        SensorBatches(StreamConsumer(broker, specs, group=f"{where}-serve"),
                      batch_size=100, keep_labels=True),
        OutputSequence(broker, "model-predictions", partition=0),
        threshold=threshold)
    t0 = time.perf_counter()
    n = scorer.score_available()
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    payloads = [m.value.decode() for m in broker.fetch(
        "model-predictions", 0, 0, KSQL_CARS + 1)]
    if n != KSQL_CARS or len(payloads) != KSQL_CARS:
        raise AssertionError(f"{where} scored {n} rows, wrote "
                             f"{len(payloads)}")
    cpu_params = {k: v.cpu() for k, v in trainer.state.params.items()}
    want, x = _recompute_ksql(broker, cpu_params)
    err_first, err_all, anomalies = _check_serve_payloads(
        payloads, want, x, threshold, where)
    info = {"fit_seconds": fit_s, "fit_ms": 1e3 * fit_s,
            "kernel_ms": kernel_ms,
            "host_pipeline_s": hist["host_pipeline_s"],
            "device_compute_s": hist["device_compute_s"],
            "loss_first": hist["loss"][0], "loss_last": hist["loss"][-1],
            "fit_max_abs_err": err, "kernel_launches": launches,
            "kernel_launches_by_design": by_design,
            "threshold": threshold, "rows_scored": n,
            "score_seconds": score_s, "score_rows_per_s": n / score_s,
            "payload_max_err_first_100": err_first,
            "payload_max_err_all": err_all, "anomalies": anomalies}
    if bound:
        info.update(params_bound=public_bound(bound),
                    fit_final_params_drift=drift)
    return {"launches": launches, "launches_by_design": by_design,
            "max_abs_err": err, "info": info}


def phase_ksql_path(card: str) -> dict:
    """The reference's KSQL stage on the card's host feeding the B1 fit:
    JSON on sensor-data → the reference DDL → Avro on SENSOR_DATA_S_AVRO
    → one fit launch → the scorer into model-predictions."""
    reset_launches()
    reset_fit_launches()
    stage = _ksql_stage()
    broker = stage["broker"]
    bs = _ksql_batches(broker, "ksql-fit")
    straight = _ksql_batches(_ksql_straight_avro(), "ksql-fit")
    same = len(bs) == len(straight) == 100 and all(
        np.array_equal(a.x, b.x) and np.array_equal(a.mask, b.mask)
        for a, b in zip(bs, straight))
    if not same:
        raise AssertionError("ksql_path: the KSQL leg's batches differ from "
                             "the same rows published straight as Avro")
    fs = _fit_and_score(broker, bs, "ksql_path")
    attention = {k: v for k, v in path_launches().items() if k != "fused_fit"}
    if any(attention.values()):
        raise AssertionError(f"ksql_path launched {attention}")
    if stage["raw_produce_records"]:
        raise AssertionError("ksql_path: the in-memory stage took a raw "
                             "produce leg")
    raw_leg = _ksql_raw_leg(broker)
    legs = stage["legs"]
    info = {"phase": "ksql_path", "card": card, "cars": KSQL_CARS,
            "partitions": KSQL_PARTITIONS, "schema_id": stage["schema_id"],
            "subjects": stage["subjects"],
            "publish_json_s": stage["publish_s"], "pump_s": stage["pump_s"],
            "pump_rounds": stage["pump_rounds"],
            "json_to_avro_records_per_s":
                legs["SENSOR_DATA_S_AVRO"]["records_per_s"],
            "rekey_records_per_s":
                legs["SENSOR_DATA_S_AVRO_REKEY"]["records_per_s"],
            "ctas_records_per_s":
                legs["SENSOR_DATA_EVENTS_PER_5MIN_T"]["records_per_s"],
            "legs": legs, "fallback_rows": stage["fallback_rows"],
            "json_decode_rows": stage["json_decode_rows"],
            "plain_leg_records_checked": stage["plain_checked"],
            "wire_produce_refused": stage["wire_produce_refused"],
            "batches_equal_straight_avro": same,
            "durable_raw_leg": raw_leg, **fs["info"]}
    emit(info)
    return {k: fs[k] for k in ("launches", "launches_by_design",
                               "max_abs_err")}


def _ksql_topics(broker) -> dict:
    """The AVRO legs' records: (offset, key, value, ts) a partition."""
    return {t: [[(m.offset, m.key, m.value, m.timestamp_ms)
                 for m in broker.fetch(t, p, 0, KSQL_CARS + 1)]
                for p in range(broker.topic(t).partitions)]
            for t in ("SENSOR_DATA_S_AVRO", "SENSOR_DATA_S_AVRO_REKEY")}


def _ksql_raw_leg(classic) -> dict:
    """The same stage on a durable broker: its JSON→AVRO leg ships every
    record as pre-framed RAW_PRODUCE batches (the engine frames once, at
    conversion), and both AVRO legs' topics equal the classic in-memory
    stage's record for record (keys, values, timestamps, partitions,
    offsets)."""
    d = tempfile.mkdtemp(prefix="chip_smoke_ksql_")
    try:
        stage = _ksql_stage(store_dir=d)
        durable = stage["broker"]
        try:
            if stage["raw_produce_records"] != KSQL_CARS:
                raise AssertionError(f"ksql_path: the durable stage's raw "
                                     f"leg carried "
                                     f"{stage['raw_produce_records']} of "
                                     f"{KSQL_CARS} records")
            if _ksql_topics(durable) != _ksql_topics(classic):
                raise AssertionError("ksql_path: the raw leg's topics "
                                     "differ from the classic leg's")
        finally:
            durable.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    legs = stage["legs"]
    return {"raw_produce_records": stage["raw_produce_records"],
            "frame_encode": stage["frame_encode"],
            "json_to_avro_records_per_s":
                legs["SENSOR_DATA_S_AVRO"]["records_per_s"],
            "pump_s": stage["pump_s"], "topics_equal_classic": True}


#: the connections the platform's fleet opens at most (``start_fleet``)
DEMO_CONNS = 64
#: the demo CLI's summary keys (``iotml/cli/demo.py``'s)
DEMO_KEYS = ("cars", "mqtt_messages_bridged", "ksql_avro_records",
             "trained_records_per_epoch", "epochs", "loss_first_to_last",
             "anomaly_threshold", "scored", "anomalies_flagged", "roc_auc",
             "avg_precision", "eval_report", "wall_seconds")


def _demo_cli(card: str) -> dict:
    """(a) ``python -m iotml_torch.cli.demo`` at its defaults, in-process on
    the card: the JAX demo test's invariants and one B1 launch, through
    rows."""
    reset_launches()
    reset_fit_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = demo_cli.main([])
    wall_s = time.perf_counter() - t0
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    text = out.getvalue()
    if rc != 0 or "{" not in text:
        raise AssertionError(f"demo_path: the demo returned {rc}: {text}")
    summary = json.loads(text[text.index("{"):])
    if tuple(summary) != DEMO_KEYS:
        raise AssertionError(f"demo_path: summary keys {list(summary)}")
    bridged = summary["mqtt_messages_bridged"]
    loss = summary["loss_first_to_last"]
    if not (bridged > 0 and summary["ksql_avro_records"] == bridged
            and summary["scored"] == summary["ksql_avro_records"]
            and loss[1] <= loss[0]):
        raise AssertionError(f"demo_path: the demo's invariants fail: "
                             f"{summary}")
    if launches != 1 or by_design["rows"] != 1:
        raise AssertionError(f"demo_path: the demo launched the fit kernel "
                             f"{launches}x ({by_design}), not once through "
                             f"rows")
    attention = {k: v for k, v in path_launches().items() if k != "fused_fit"}
    if any(attention.values()):
        raise AssertionError(f"demo_path launched {attention}")
    emit({"phase": "demo_path", "part": "demo_cli", "card": card,
          "argv": [], "wall_seconds": wall_s, "summary": summary,
          "kernel_launches": launches,
          "kernel_launches_by_design": by_design})
    return {"launches": launches, "launches_by_design": by_design}


def _demo_tick():
    """One tick of the reference's fleet as ``Platform.start_fleet``
    writes it: (client id, MQTT topic, JSON payload) a car."""
    scenario = FleetScenario(num_cars=KSQL_CARS, failure_rate=0.01)
    gen = FleetGenerator(scenario)
    cols = gen.step_columns()
    return [(scenario.car_id(i), _bridge_key(scenario, i).decode(),
             json.dumps(gen.row_record(cols, i, KSQL_CAR_SCHEMA)).encode())
            for i in range(KSQL_CARS)]


def _mqtt_publish_tick(port: int, tick, front, forwarded,
                       batched: bool = False) -> dict:
    """Publish ``tick`` from this thread over DEMO_CONNS ``MqttClient``
    connections (car i on connection i % DEMO_CONNS, QoS 0), one
    ``publish`` a message as ``start_fleet`` does, or with ``batched``
    one ``publish_many`` (one ``sendall``) a connection; then wait until
    ``forwarded()`` counts every record, with a deadline that fails the
    phase.  Returns the seconds and the epoll front's largest paused
    count seen."""
    clients = [MqttClient("127.0.0.1", port, tick[i][0])
               for i in range(DEMO_CONNS)]
    per_conn = [[(topic, payload) for _cid, topic, payload
                 in tick[c::DEMO_CONNS]] for c in range(DEMO_CONNS)]
    paused = 0
    try:
        t0 = time.perf_counter()
        if batched:
            for c, items in zip(clients, per_conn):
                c.publish_many(items)
        else:
            for i, (_cid, topic, payload) in enumerate(tick):
                clients[i % DEMO_CONNS].publish(topic, payload, qos=0)
                if front is not None and i % 1024 == 0:
                    paused = max(paused, front.paused_count)
        publish_s = time.perf_counter() - t0
        deadline = time.monotonic() + 300
        while forwarded() < len(tick):
            if time.monotonic() > deadline:
                raise AssertionError(f"demo_path: {forwarded()} of "
                                     f"{len(tick)} records bridged in 300 s")
            if front is not None:
                paused = max(paused, front.paused_count)
            time.sleep(0.005)
        forward_s = time.perf_counter() - t0
    finally:
        for c in clients:
            c.disconnect()
    return {"publish_s": publish_s, "forward_s": forward_s,
            "publish_records_per_s": len(tick) / publish_s,
            "bridge_forwards_per_s": len(tick) / forward_s,
            "max_paused": paused}


def _sensor_data(broker) -> list:
    """sensor-data's records as a multiset a partition, and each key's
    values in offset order a partition."""
    out = []
    for p in range(KSQL_PARTITIONS):
        msgs = broker.fetch("sensor-data", p, 0,
                            broker.end_offset("sensor-data", p) + 1)
        by_key = collections.defaultdict(list)
        for m in msgs:
            by_key[m.key].append(m.value)
        out.append((collections.Counter((m.key, m.value) for m in msgs),
                    dict(by_key)))
    return out


def _by_key(broker) -> Broker:
    """SENSOR_DATA_S_AVRO's records on a new broker, each partition's in
    the order of their keys."""
    out = Broker()
    out.create_topic("SENSOR_DATA_S_AVRO", partitions=KSQL_PARTITIONS)
    for p in range(KSQL_PARTITIONS):
        msgs = sorted(broker.fetch("SENSOR_DATA_S_AVRO", p, 0, KSQL_CARS + 1),
                      key=lambda m: m.key)
        out.produce_many("SENSOR_DATA_S_AVRO",
                         [(m.key, m.value, m.timestamp_ms) for m in msgs])
        if out.end_offset("SENSOR_DATA_S_AVRO", p) != len(msgs):
            raise AssertionError("demo_path: a key changed partition")
    return out


def _bare_front(kind: str, tick, want, batched: bool) -> dict:
    """The tick through one front alone onto a fresh 4-partition broker:
    ``epoll`` (``MqttEventServer`` → ``MqttBroker`` → ``KafkaBridge``, the
    platform's front without the rest), ``native`` (``NativeIngestBridge``
    into the broker) or ``native_wire`` (``NativeIngestBridge`` into a
    wire client of the port's server over the broker: the remote front,
    where the bridge takes its raw leg, frames once and RAW_PRODUCE, as
    JAX's does); its sensor-data must equal ``want``."""
    stream = backing = Broker()
    server = None
    stats0 = dict(native.stats)
    if kind == "native_wire":
        server = KafkaWireServer(backing).start()
        stream = KafkaWireBroker(f"127.0.0.1:{server.port}")
    if kind.startswith("native"):
        front = NativeIngestBridge(stream,
                                   partitions=KSQL_PARTITIONS).start()
        port, bridge, stop = front.port, front, front.stop
    else:
        stream.create_topic("sensor-data", partitions=KSQL_PARTITIONS)
        mqtt = MqttBroker()
        bridge = KafkaBridge(mqtt, stream, partitions=KSQL_PARTITIONS)
        front = MqttEventServer(mqtt).start()
        port, stop = front.port, front.stop
    try:
        out = _mqtt_publish_tick(port, tick, front if kind == "epoll"
                                 else None, bridge.forwarded, batched)
        if kind.startswith("native"):
            out["produce_seconds"] = bridge.produce_seconds
    finally:
        stop()
        if server is not None:
            stream.close()
            server.shutdown()
            server.server_close()
    if kind == "native_wire":
        raw = bridge._raw
        if raw is None or raw.engaged is not True or not raw.raw_batches:
            raise AssertionError("demo_path: the native bridge into a wire "
                                 "client did not take its raw leg")
        out["raw_produce_batches"] = raw.raw_batches
        out["native_frame_stats"] = {k: native.stats[k] - stats0[k]
                                     for k in native.stats
                                     if k.startswith("frame_")}
    if _sensor_data(backing) != want:
        how = "batched" if batched else "a publish a message"
        raise AssertionError(f"demo_path: the {kind} front's sensor-data "
                             f"({how}) differs from the straight publish")
    return out


def _demo_fleet_tick(card: str) -> dict:
    """(b) One tick of the reference's 100,000 cars over both MQTT fronts:
    the platform's epoll front (bridge → sensor-data → KSQL → fit →
    scorer) and the native ingest front onto a second broker; both
    fronts' sensor-data equal to ``_ksql_fleet_json``'s straight
    publish."""
    tick = _demo_tick()
    straight = Broker()
    straight.create_topic("sensor-data", partitions=KSQL_PARTITIONS)
    _ksql_fleet_json(straight)
    want = _sensor_data(straight)
    evicted = obs_metrics.default_registry.counter(
        "mqtt_overload_slow_consumers_evicted_total")
    evicted0 = evicted.value()

    plat = Platform(partitions=KSQL_PARTITIONS)  # the card
    # the KSQL pump thread sleeps an hour between rounds: pump_now
    # drives them after the tick, so the pump is timed alone
    plat.ksql.pump_interval_s = 3600.0
    plat.start()
    try:
        epoll = _mqtt_publish_tick(plat.mqtt.port, tick, plat.mqtt,
                                   plat.bridge.forwarded)
        epoll["evictions"] = evicted.value() - evicted0
        epoll["paused_now"] = plat.mqtt.paused_count
        if _sensor_data(plat.broker) != want:
            raise AssertionError("demo_path: the epoll front's sensor-data "
                                 "differs from the straight publish")
        rounds = []
        t0 = time.perf_counter()
        while True:
            n = plat.pump()
            rounds.append(n)
            if n == 0:
                break
        pump_s = time.perf_counter() - t0
        avro = sum(plat.broker.end_offset("SENSOR_DATA_S_AVRO", p)
                   for p in range(KSQL_PARTITIONS))
        if avro != KSQL_CARS:
            raise AssertionError(f"demo_path: SENSOR_DATA_S_AVRO holds "
                                 f"{avro} records")
        # the 64 connections interleave the cars, so each partition's
        # order differs from run to run: the rows in their keys' order
        # must be the straight publish's batches, and the fit takes them
        # in the fleet's own order, its params held to the float64 fit
        # within the float32 order noise of the plain version on those
        # rows (a fixed params bound fails some orders: PERF.md §6)
        keyed = _ksql_batches(_by_key(plat.broker), "demo-keyed")
        straight = _ksql_batches(_ksql_straight_avro(), "demo-fit")
        same = len(keyed) == len(straight) == 100 and all(
            np.array_equal(a.x, b.x) and np.array_equal(a.mask, b.mask)
            for a, b in zip(keyed, straight))
        if not same:
            raise AssertionError("demo_path: the MQTT path's batches (rows "
                                 "in key order) differ from the same rows "
                                 "published straight as Avro")
        bs = _ksql_batches(plat.broker, "demo-fit")
        reset_launches()
        reset_fit_launches()
        fs = _fit_and_score(plat.broker, bs, "demo_path",
                            bound_orders=DEMO_FIT_ORDERS)
        attention = {k: v for k, v in path_launches().items()
                     if k != "fused_fit"}
        if any(attention.values()):
            raise AssertionError(f"demo_path launched {attention}")
    finally:
        plat.stop()

    nat = _bare_front("native", tick, want, batched=False)
    nat_wire = _bare_front("native_wire", tick, want, batched=False)
    # the same tick with one sendall a connection: what the fronts take
    # when the clients' per-message syscalls are out of the way
    batched = {kind: _bare_front(kind, tick, want, batched=True)
               for kind in ("epoll", "native")}
    emit({"phase": "demo_path", "part": "fleet_tick", "card": card,
          "cars": KSQL_CARS, "connections": DEMO_CONNS,
          "partitions": KSQL_PARTITIONS,
          "sensor_data_equal_straight": ["epoll", "native", "native_wire",
                                         "epoll_batched", "native_batched"],
          "epoll_front": epoll, "native_front": nat,
          "native_front_into_wire_client_raw_leg": nat_wire,
          "fit_rows": "the fleet's own order",
          "epoll_front_batched": batched["epoll"],
          "native_front_batched": batched["native"],
          "batches_in_key_order_equal_straight_avro": same,
          "ksql_pump_s": pump_s, "pump_rounds": rounds, **fs["info"]})
    return fs


def phase_demo_path(card: str) -> dict:
    """The reference's whole story on the card, as users run it: (a) the
    demo CLI at its defaults, (b) one tick of the reference's fleet over
    both MQTT fronts feeding the KSQL stage, B1 and the scorer."""
    cli = _demo_cli(card)
    tick = _demo_fleet_tick(card)
    return {"launches": cli["launches"] + tick["launches"],
            "launches_by_design": {
                d: cli["launches_by_design"][d]
                + tick["launches_by_design"][d] for d in fused_train.DESIGNS},
            "max_abs_err": tick["max_abs_err"]}


#: the reference's topic: 100,000 cars at one message per 10 s
#: (scenario.xml:48-49) over 10 partitions with retention.ms=100000
#: (01_installConfluentPlatform.sh:180-183): ten ticks are one retention
#: window, 1,000,000 records of ~195 bytes a frame
STORE_CARS, STORE_TICKS, STORE_PARTS = 100_000, 10, 10
STORE_RETENTION_MS = 100_000
STORE_TOPIC = "SENSOR_DATA_S_AVRO"
#: the crash child's produce_many and the acks it is killed after
STORE_CRASH_BATCH, STORE_CRASH_ACKS = 10_000, 4
STORE_GROUP = "store-crash"
#: the backfill replays from tick 5's timestamp, three rounds
STORE_BACKFILL_TICK, STORE_BACKFILL_ROUNDS = 5, 3
#: the compacted topic's segments (so that they seal) and its tombstones:
#: one car in STORE_TOMBSTONE_EVERY deleted after the last update
STORE_COMPACT_SEGMENT, STORE_TOMBSTONE_EVERY = 1 << 20, 1_000
#: the platform's short fleet, one tick of this many cars over MQTT
STORE_PLATFORM_CARS = 20_000
#: (h)'s IOTML_RAW_BATCH_BYTES: past two ticks' produce_many batches of a
#: partition (~1.95 MB each), so that a raw fetch from the sparse-index
#: entry at or before any cursor reaches past it
STORE_RING_BATCH_BYTES = 4 << 20


def _store_ticks(n: int):
    """The reference fleet's first ``n`` ticks, one at a time, as
    ``FleetGenerator.publish`` writes them: [(car key, Confluent-framed
    Avro value, the tick's ms)], one message per car per 10 s."""
    cars = STORE_CARS
    gen = FleetGenerator(FleetScenario(num_cars=cars, interval_s=10))
    codec = native.NativeCodec(KSQL_CAR_SCHEMA)
    keys = [gen.scenario.car_id(i).encode() for i in range(cars)]
    for _ in range(n):
        cols = gen.step_columns()
        msgs = codec.encode_batch(
            gen.sensor_matrix(cols),
            cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
        ts = int(gen.t * 1000)
        yield [(k, m, ts) for k, m in zip(keys, msgs)]


#: the crash child: mounts the store with fsync=always, appends tick
#: STORE_TICKS + 1 in produce_many batches, commits each batch's ends for
#: STORE_GROUP and then prints them, one JSON line an ack
STORE_CHILD = f"""
import json, sys
from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.store import StorePolicy
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker
STORE_CARS = {STORE_CARS}
{inspect.getsource(_store_ticks)}
b = Broker(store_dir=sys.argv[1], store_policy=StorePolicy(fsync="always"))
*_, tick = _store_ticks({STORE_TICKS + 1})
for i in range(0, len(tick), {STORE_CRASH_BATCH}):
    b.produce_many({STORE_TOPIC!r}, tick[i:i + {STORE_CRASH_BATCH}])
    ends = [b.end_offset({STORE_TOPIC!r}, p) for p in range({STORE_PARTS})]
    b.commit_many({STORE_GROUP!r}, {STORE_TOPIC!r}, list(enumerate(ends)))
    print(json.dumps(ends), flush=True)
print("done", flush=True)
"""


def _crash_child(d: str, acks: int, deadline_s: float = 600.0) -> list:
    """STORE_CHILD on ``d``, SIGKILLed once it has printed ``acks`` ack
    lines (a deadline fails the phase); returns the lines read."""
    proc = subprocess.Popen([sys.executable, "-c", STORE_CHILD, d],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(Path(__file__).parent))
    lines: "queue.Queue" = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    got = []
    try:
        deadline = time.monotonic() + deadline_s
        while len(got) < acks:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(),
                                             0.001))
            except queue.Empty:
                raise AssertionError(f"store_path: the crash child acked "
                                     f"{len(got)} batches in {deadline_s} "
                                     f"s") from None
            if line is None or line.strip() == "done":
                raise AssertionError(f"store_path: the crash child ended "
                                     f"after {len(got)} acks: "
                                     f"{proc.stderr.read()}")
            got.append(json.loads(line))
        proc.kill()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        reader.join(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    if proc.returncode != -9:
        raise AssertionError(f"store_path: the crash child exited "
                             f"{proc.returncode}, not by SIGKILL")
    return got


def _store_batches(broker, group: str, topic: str = STORE_TOPIC):
    """The reference job's 100 batches of 100 normal rows from offset 0 of
    every partition."""
    specs = [f"{topic}:{p}:0" for p in range(broker.topic(topic).partitions)]
    return list(next(SensorBatches(StreamConsumer(broker, specs,
                                                  group=group),
                                   batch_size=100, take=100,
                                   only_normal=True).epochs(1)))


@contextlib.contextmanager
def _ring_read(where: str):
    """Around reads of a durable broker: yields a dict that, after the
    block, must show the columnar ring at work: ``FrameDecoder`` calls,
    rows in ``native.stats["frame_decode_rows"]`` and no chunk fallen
    back to the message-list leg (no ``StreamConsumer.poll``).  Pass the
    batchers read in the block as ``seen["batchers"]``: each must hold a
    ``DecodeRing``."""
    rows0 = native.stats["frame_decode_rows"]
    seen = {"batchers": []}
    with _recording(native.FrameDecoder, "decode_into") as decodes, \
            _recording(StreamConsumer, "poll") as polls:
        yield seen
    seen.update(decode_calls=len(decodes), fallback_chunks=len(polls),
                frame_decode_rows=native.stats["frame_decode_rows"] - rows0)
    rings = [isinstance(sb._ring, pipeline.DecodeRing)
             for sb in seen.pop("batchers")]
    if not (rings and all(rings)) or not decodes or polls or \
            seen["frame_decode_rows"] <= 0:
        raise AssertionError(f"{where}: the columnar ring did not carry the "
                             f"read: rings {rings}, {seen}")


def _same_batches(a, b, where: str) -> None:
    if len(a) != len(b) or not all(
            np.array_equal(x.x, y.x) and np.array_equal(x.mask, y.mask)
            for x, y in zip(a, b)):
        raise AssertionError(f"store_path: {where}'s batches differ")


def _one_fit(bs, where: str, design_counts: dict):
    """``fit_compiled`` over ``bs`` for 20 epochs on the card: exactly
    one B1 launch, through rows (counted into ``design_counts``)."""
    trainer = Trainer(CAR_AUTOENCODER)
    trainer._ensure_state()
    before = _clone_state(trainer.state)
    launches = fused_train.fused_fit.launches
    rows = fused_train.fused_fit.launches_by_design["rows"]
    t0 = time.perf_counter()
    hist = trainer.fit_compiled(bs, epochs=20)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if fused_train.fused_fit.launches != launches + 1 or \
            fused_train.fused_fit.launches_by_design["rows"] != rows + 1:
        raise AssertionError(f"store_path: {where} launched B1 "
                             f"{fused_train.fused_fit.launches - launches}"
                             f"x, not once through rows")
    design_counts[where] = 1
    return trainer, before, hist, seconds


def _same_fit(a, b, where: str) -> None:
    """Two fits of exactly equal batches from the same start state: the
    kernel's outputs equal bit for bit."""
    (ta, ha), (tb, hb) = a, b
    if ha["loss"] != hb["loss"] or ha["accuracy"] != hb["accuracy"] or \
            not all(torch.equal(ta.state.params[k], tb.state.params[k])
                    for k in PARAM_NAMES):
        raise AssertionError(f"store_path: {where}'s fit is not bit for "
                             f"bit the recovered log's")


#: the row orders a fit gate holds (order 0 as served, order k > 0 the
#: rows permuted with seed k) and, for the params bound, the seeded
#: shuffles of each batch's rows that join each order's rows as given;
#: store_path's 6 orders (12 before cluster_path joined the run) keep the
#: whole run inside its time limit, and ``--store-fit-orders N`` sweeps
#: more
STORE_FIT_ORDERS, DEMO_FIT_ORDERS, BOUND_SHUFFLES = 6, 6, 8
#: 20-epoch fits: what the path's own fit runs
FIT_EPOCHS = 20


def params_drift(kernel, plain, float64) -> dict:
    """Elements outside STATE_TOL and the largest absolute difference of
    three param trees, pairwise: kernel vs plain, kernel vs float64,
    plain vs float64."""
    def outside(a, b):
        n, m = 0, 0.0
        for key in PARAM_NAMES:
            got, want = a[key].double().cpu(), b[key].double().cpu()
            diff = (got - want).abs()
            n += int((diff > STATE_TOL["atol"]
                      + STATE_TOL["rtol"] * want.abs()).sum())
            m = max(m, float(diff.max()))
        return {"outside": n, "max_abs": m}

    return {"elements": sum(v.numel() for v in kernel.values()),
            "kernel_vs_plain": outside(kernel, plain),
            "kernel_vs_float64": outside(kernel, float64),
            "plain_vs_float64": outside(plain, float64)}


def fit_float64(before: TrainState, xs, masks, epochs: int) -> TrainState:
    """The plain version's fit with the start state and the rows in
    float64."""
    def f64(t):
        return {k: v.double() for k, v in t.items()}

    opt = before.opt_state
    state, _loss, _acc = fused_train.fused_fit_reference(
        TrainState(step=before.step, params=f64(before.params),
                   opt_state=type(opt)(count=opt.count, mu=f64(opt.mu),
                                       nu=f64(opt.nu))),
        xs.double(), masks.double(), epochs)
    return state


def plain_fits(start: TrainState, xs, masks, epochs: int) -> list:
    """``fused_fit_reference``'s arithmetic for K row orders at once: ``xs``
    [K, S, B, F] (float32 or float64), ``masks`` [S, B] shared; returns
    each order's final params.  Every product and sum is the plain
    version's, batched over the orders, so each fit is that order's fit
    in the dtype given, its float32 sums in the batched kernels' order."""
    K, S, B, F = xs.shape
    dt = xs.dtype
    opt = start.opt_state
    p = [start.params[k].to(dt).expand(K, *start.params[k].shape).clone()
         for k in PARAM_NAMES]
    m = [opt.mu[k].to(dt).expand(K, *opt.mu[k].shape).clone()
         for k in PARAM_NAMES]
    v = [opt.nu[k].to(dt).expand(K, *opt.nu[k].shape).clone()
         for k in PARAM_NAMES]
    # the bias corrections in float32 whatever ``dt``, as the plain
    # version computes them (and so ``fit_float64``)
    log_b1 = torch.tensor(math.log(fused_train.B1), dtype=torch.float32,
                          device=xs.device)
    log_b2 = torch.tensor(math.log(fused_train.B2), dtype=torch.float32,
                          device=xs.device)
    l1, lr = 1e-7, 1e-3
    for i in range(epochs * S):
        x = xs[:, i % S]
        msk = masks[i % S].to(dt).reshape(1, B, 1)
        w1, b1, w2, b2, w3, b3, w4, b4 = p
        z1 = x @ w1.transpose(1, 2) + b1[:, None]
        h1 = torch.tanh(z1)
        z2 = h1 @ w2.transpose(1, 2) + b2[:, None]
        h2 = torch.clamp_min(z2, 0.0)
        z3 = h2 @ w3.transpose(1, 2) + b3[:, None]
        h3 = torch.tanh(z3)
        z4 = h3 @ w4.transpose(1, 2) + b4[:, None]
        out = torch.clamp_min(z4, 0.0)
        denom = torch.clamp_min(torch.sum(msk) * F, 1.0)
        diff = out - x
        dz4 = (2.0 / denom) * diff * msk * (z4 > 0.0)
        dz3 = (dz4 @ w4) * (1.0 - h3 * h3)
        dz2 = (dz3 @ w3) * (z2 > 0.0)
        dh1 = dz2 @ w2 + (l1 / B) * torch.sign(h1)
        dz1 = dh1 * (1.0 - h1 * h1)
        grads = (dz1.transpose(1, 2) @ x, dz1.sum(1),
                 dz2.transpose(1, 2) @ h1, dz2.sum(1),
                 dz3.transpose(1, 2) @ h2, dz3.sum(1),
                 dz4.transpose(1, 2) @ h3, dz4.sum(1))
        t = float(opt.count + i + 1)
        c1 = 1.0 - torch.exp(t * log_b1)
        c2 = 1.0 - torch.exp(t * log_b2)
        for k, g in enumerate(grads):
            m[k] = fused_train.B1 * m[k] + (1.0 - fused_train.B1) * g
            v[k] = fused_train.B2 * v[k] + (1.0 - fused_train.B2) * g * g
            p[k] = p[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2)
                                               + fused_train.EPS)
    return [dict(zip(PARAM_NAMES, (t[k] for t in p))) for k in range(K)]


def row_orders(rows: np.ndarray, orders: int) -> list:
    """``orders`` orders of ``rows``: order 0 as given, order k > 0
    permuted with seed k."""
    return [rows if k == 0 else
            rows[np.random.default_rng(k).permutation(len(rows))]
            for k in range(orders)]


def order_noise_bound(start: TrainState, orders: list, masks,
                      epochs: int = FIT_EPOCHS,
                      shuffles: int = BOUND_SHUFFLES) -> dict:
    """The params bound of a fit gate, from the plain version alone: each
    order's rows (as given, and with each batch's rows in ``shuffles``
    seeded shuffles) fit in float32 against the same order fit in
    float64; the bound is the largest count of elements outside
    STATE_TOL and the largest absolute difference that any of those
    float32 fits gives: float32 order noise.  Returns the bound, the
    samples and each order's float64 params."""
    S, B = masks.shape
    f64 = plain_fits(start, torch.stack([
        torch.from_numpy(o.reshape(S, B, -1)) for o in orders])
        .to(masks.device).double(), masks, epochs)
    variants, owner = [], []
    for k, o in enumerate(orders):
        batches = o.reshape(S, B, -1)
        for s in range(shuffles + 1):
            if s:
                rng = np.random.default_rng(1000 * k + s)
                batches = np.stack([b[rng.permutation(B)]
                                    for b in o.reshape(S, B, -1)])
            variants.append(torch.from_numpy(np.ascontiguousarray(batches)))
            owner.append(k)
    t0 = time.perf_counter()
    fits = plain_fits(start, torch.stack(variants).to(masks.device), masks,
                      epochs)
    if masks.is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    samples = [params_drift(f, f, f64[k])["plain_vs_float64"]
               for f, k in zip(fits, owner)]
    return {"outside": max(d["outside"] for d in samples),
            "max_abs": max(d["max_abs"] for d in samples),
            "fits": len(samples), "orders": len(orders),
            "shuffles_per_order": shuffles, "seconds": seconds,
            "per_order": [
                {"outside": max(d["outside"] for d, k2 in zip(samples, owner)
                                if k2 == k),
                 "max_abs": max(d["max_abs"] for d, k2 in zip(samples, owner)
                                if k2 == k)} for k in range(len(orders))],
            "float64": f64}


def within_bound(drift: dict, bound: dict) -> bool:
    """Whether a fit's params lie no farther from the float64 fit than
    the bound (``order_noise_bound``) allows, in count and in size."""
    return drift["outside"] <= bound["outside"] and \
        drift["max_abs"] <= bound["max_abs"]


def public_bound(bound: dict) -> dict:
    return {k: v for k, v in bound.items() if k != "float64"}


def _store_fit_check(trainer, before, hist, xs, masks, bound,
                     tag: str = "store_path") -> tuple:
    """Hold the path's own fit (20 epochs, order 0) against the plain
    version on the same batches: every epoch's loss and accuracy at
    METRIC_TOL, the final Adam moments at STATE_TOL and the step count
    (``check_fit``); and its params against the float64 fit of the same
    rows within ``bound``, derived before from the plain version alone.
    Returns (largest absolute difference checked, the params' drift)."""
    plain = fused_train.fused_fit_reference(before, xs, masks, FIT_EPOCHS)
    err = check_fit(tag, (trainer.state, torch.tensor(hist["loss"]),
                          torch.tensor(hist["accuracy"])),
                    plain, before.step + xs.shape[0] * FIT_EPOCHS,
                    parts=("mu", "nu"))
    drift = params_drift(trainer.state.params, plain[0].params,
                         bound["float64"][0])
    if not within_bound(drift["kernel_vs_float64"], bound):
        raise AssertionError(f"{tag} params: farther from the float64 "
                             f"fit than float32 order noise "
                             f"{public_bound(bound)}: {drift}")
    return err, drift


def fit_orders_gate(card: str, start: TrainState, rows: np.ndarray,
                    bound: dict, strict: bool) -> dict:
    """B1 and the plain version with each batch's rows reversed (the same
    sums in another float32 order), each fit for 20 epochs from
    ``start`` on the bound's orders of ``rows``, held to ``bound``
    against each order's float64 fit; B1 also against the plain version
    at the fit bounds (reported).  One line an order, then a summary;
    with ``strict`` an order outside the bound fails the run.  These B1
    launches compare the kernel with its plain version: they run outside
    every path's count."""
    S, B = len(rows) // 100, 100
    dev = start.params[PARAM_NAMES[0]].device
    masks = torch.ones(S, B, device=dev)
    failing = {"fit_bounds": [], "kernel_outside_bound": [],
               "plain_rows_reversed_outside_bound": []}
    lines = []
    for order, x in enumerate(row_orders(rows, bound["orders"])):
        xs = torch.from_numpy(x.reshape(S, B, -1)).to(dev)
        kernel = fused_train.fused_fit(start, xs, masks, FIT_EPOCHS)
        plain = fused_train.fused_fit_reference(start, xs, masks, FIT_EPOCHS)
        try:
            check_fit(f"order {order}", kernel, plain, S * FIT_EPOCHS)
            bounds = None
        except AssertionError as e:
            bounds = str(e)
        f64 = bound["float64"][order]
        drift = params_drift(kernel[0].params, plain[0].params, f64)
        rev = params_drift(fused_train.fused_fit_reference(
            start, xs.flip(1), masks.flip(1), FIT_EPOCHS)[0].params,
            plain[0].params, f64)
        k_ok = within_bound(drift["kernel_vs_float64"], bound)
        r_ok = within_bound(rev["kernel_vs_float64"], bound)
        if bounds is not None:
            failing["fit_bounds"].append(order)
        if not k_ok:
            failing["kernel_outside_bound"].append(order)
        if not r_ok:
            failing["plain_rows_reversed_outside_bound"].append(order)
        line = {"order": order, "card": card,
                "passes_fit_bounds": bounds is None,
                "kernel_vs_plain": drift["kernel_vs_plain"],
                "kernel_vs_float64": drift["kernel_vs_float64"],
                "plain_vs_float64": drift["plain_vs_float64"],
                "plain_rows_reversed_vs_float64": rev["kernel_vs_float64"],
                "noise_of_this_order": bound["per_order"][order],
                "kernel_within_bound": k_ok,
                "plain_rows_reversed_within_bound": r_ok}
        lines.append(line)
        if not strict:
            emit({**line, "fit_bounds_failure": bounds})
    summary = {"card": card, "orders": bound["orders"],
               "epochs": FIT_EPOCHS, "bound": public_bound(bound),
               "failing_orders": failing}
    if strict and (failing["kernel_outside_bound"]
                   or failing["plain_rows_reversed_outside_bound"]):
        raise AssertionError(f"store_fit_orders: outside float32 order "
                             f"noise: {summary}; {lines}")
    return {**summary, "per_order": lines}


def _store_fit_rows() -> np.ndarray:
    """store_path's fit rows: its batches from a broker holding the
    topic's first two ticks (all full: 100 of 100 normal rows)."""
    mem = Broker()
    mem.create_topic(STORE_TOPIC, partitions=STORE_PARTS)
    for tick in _store_ticks(2):
        mem.produce_many(STORE_TOPIC, tick)
    bs = _store_batches(mem, "store-fit")
    if not all(x.mask.all() for x in bs):
        raise AssertionError("store_path's batches are not full")
    return np.concatenate([x.x for x in bs])


def store_fit_orders(card: str, orders: int) -> None:
    """``--store-fit-orders N``: the bound from the plain version alone on
    N orders of store_path's rows, then B1 and the reversed plain fit on
    every order against it, one line an order and a summary line,
    failing nothing."""
    rows = _store_fit_rows()
    trainer = Trainer(CAR_AUTOENCODER)
    trainer._ensure_state()
    masks = torch.ones(len(rows) // 100, 100, device="cuda")
    bound = order_noise_bound(trainer.state, row_orders(rows, orders),
                              masks)
    summary = fit_orders_gate(card, trainer.state, rows, bound, strict=False)
    summary.pop("per_order")
    emit({"summary": True, **summary})


def phase_fit_orders(card: str, store: dict) -> dict:
    """After store_path's launches are read: its rows in STORE_FIT_ORDERS
    orders, B1 and the reversed plain fit held to the bound store_path
    derived (``fit_orders_gate``, strict)."""
    out = fit_orders_gate(card, store["fit_start"], store["fit_rows"],
                          store["bound"], strict=True)
    emit({"phase": "fit_orders", **out})
    return out


def _store_append(root: str) -> dict:
    """(a) The retention window into ``Broker(store_dir=D)`` through the
    fused ``produce_many``, a tick at a time (fsync=interval, the store.*
    defaults); one tick again under fsync=never and fsync=always (one
    produce_many, and in batches of 1,000) in fresh directories."""
    d = os.path.join(root, "store")
    native.reset_stats()
    b = Broker(store_dir=d)
    b.create_topic(STORE_TOPIC, partitions=STORE_PARTS,
                   retention_ms=STORE_RETENTION_MS)
    gen_s = append_s = 0.0
    ticks = _store_ticks(STORE_TICKS)
    first = None
    for _ in range(STORE_TICKS):
        t0 = time.perf_counter()
        tick = next(ticks)
        t1 = time.perf_counter()
        b.produce_many(STORE_TOPIC, tick)
        append_s += time.perf_counter() - t1
        gen_s += t1 - t0
        first = first or tick
    t0 = time.perf_counter()
    b.flush()
    flush_s = time.perf_counter() - t0
    records = STORE_CARS * STORE_TICKS
    logs = [b.store.log_for(STORE_TOPIC, p) for p in range(STORE_PARTS)]
    if any(b.begin_offset(STORE_TOPIC, p) for p in range(STORE_PARTS)) or \
            sum(b.end_offset(STORE_TOPIC, p)
                for p in range(STORE_PARTS)) != records:
        raise AssertionError("store_path: retention trimmed the window or "
                             "records are missing")
    disk = sum(log.total_bytes() for log in logs)
    segments = [len(log._segments) for log in logs]
    framing = {k: native.stats[k] for k in ("frame_encode_rows",
                                            "frame_encode_s")}
    if framing["frame_encode_rows"] != records:
        raise AssertionError(f"store_path: the engine framed "
                             f"{framing['frame_encode_rows']} of {records}")
    b.close()
    policies = {}
    for tag, fsync, batch in (("never", "never", STORE_CARS),
                              ("always", "always", STORE_CARS),
                              ("always_batch_1000", "always", 1_000)):
        dp = os.path.join(root, f"fsync-{tag}")
        bp = Broker(store_dir=dp, store_policy=StorePolicy(fsync=fsync))
        bp.create_topic(STORE_TOPIC, partitions=STORE_PARTS)
        t0 = time.perf_counter()
        for i in range(0, len(first), batch):
            bp.produce_many(STORE_TOPIC, first[i:i + batch])
        seconds = time.perf_counter() - t0
        bp.close()
        shutil.rmtree(dp, ignore_errors=True)
        policies[tag] = {"seconds": seconds,
                         "records_per_s": STORE_CARS / seconds,
                         "produce_many_calls": len(first) // batch}
    return {"dir": d, "records": records, "generate_s": gen_s,
            "append_s": append_s, "flush_s": flush_s,
            "append_records_per_s": records / append_s,
            "append_mb_per_s": disk / append_s / 1e6, "disk_bytes": disk,
            "bytes_per_record": disk / records,
            "segments_per_partition": segments, "framing": framing,
            "fsync_one_tick": policies}


def _store_crash(d: str) -> dict:
    """(b) A child appends tick 11 with fsync=always and is SIGKILLed
    after STORE_CRASH_ACKS acks; a mount writes a torn frame onto one
    partition's active segment and is dropped without close(); the
    remount's seconds; every record served equal to the generator's
    (every acked one among them), the group's commits read back."""
    acks = _crash_child(d, STORE_CRASH_ACKS)
    crashed = Broker(store_dir=d)
    kill_tail = crashed.store.recovered_truncated_bytes()
    torn = crashed.store.log_for(STORE_TOPIC, 3).simulate_torn_write()
    truncated0 = store_recovery_truncated.value()
    del crashed  # the chaos runner's kill: no close()
    t0 = time.perf_counter()
    b = Broker(store_dir=d)
    mount_s = time.perf_counter() - t0
    truncated = store_recovery_truncated.value() - truncated0
    if truncated < torn:
        raise AssertionError(f"store_path: recovery truncated {truncated} "
                             f"bytes, the torn frame was {torn}")
    t0 = time.perf_counter()
    want = [[] for _ in range(STORE_PARTS)]
    for tick in _store_ticks(STORE_TICKS + 1):
        for e in tick:
            want[zlib.crc32(e[0]) % STORE_PARTS].append(e)
    regen_s = time.perf_counter() - t0
    since = STORE_BACKFILL_TICK * 10_000
    last, served, replay_s, ends, first_at = acks[-1], 0, 0.0, [], []
    for p in range(STORE_PARTS):
        t0 = time.perf_counter()
        msgs = b.fetch(STORE_TOPIC, p, 0, 10 ** 7)
        replay_s += time.perf_counter() - t0
        if not last[p] <= len(msgs) <= len(want[p]):
            raise AssertionError(f"store_path: partition {p} serves "
                                 f"{len(msgs)} records, {last[p]} acked")
        for i, (m, w) in enumerate(zip(msgs, want[p])):
            if (m.offset, m.key, m.value, m.timestamp_ms) != (i, *w):
                raise AssertionError(f"store_path: {p}@{i} is not the "
                                     f"generator's record")
        ends.append(len(msgs))
        first_at.append(next((m.offset for m in msgs
                              if m.timestamp_ms >= since), len(msgs)))
        served += len(msgs)
    committed = [b.committed(STORE_GROUP, STORE_TOPIC, p)
                 for p in range(STORE_PARTS)]
    if not all(last[p] <= committed[p] <= ends[p]
               for p in range(STORE_PARTS)):
        raise AssertionError(f"store_path: committed {committed}, acked "
                             f"{last}, served {ends}")
    return {"broker": b, "acks": len(acks),
            "acked_in_crash_tick": sum(last) - STORE_CARS * STORE_TICKS,
            "served": served, "written_past_last_ack": served - sum(last),
            "kill_tail_truncated_bytes": kill_tail, "torn_bytes": torn,
            "recovery_truncated_bytes": truncated, "mount_s": mount_s,
            "regenerate_s": regen_s, "replay_s": replay_s,
            "replay_records_per_s": served / replay_s,
            "committed": committed, "first_at_backfill": first_at,
            "backfill_since_ms": since}


def _store_fit_and_score(b, d: str, counts: dict) -> dict:
    """(c) The recovered log's batches → one B1 launch, held against the
    plain version at the fit bounds and, bit for bit, against the same
    fit fed from an in-memory broker with the same records; 10,000 rows
    scored into the durable model-predictions, read back after a
    remount and held against a CPU recompute."""
    specs = [f"{STORE_TOPIC}:{p}:0" for p in range(STORE_PARTS)]
    t0 = time.perf_counter()
    with _ring_read("store_path's fit") as ring_fit:
        sb = SensorBatches(StreamConsumer(b, specs, group="store-fit"),
                           batch_size=100, take=100, only_normal=True)
        ring_fit["batchers"].append(sb)
        bs = list(next(sb.epochs(1)))
    batch_s = time.perf_counter() - t0
    if len(bs) != 100 or not all(x.mask.all() for x in bs):
        raise AssertionError("store_path's batches are not 100 full ones")
    trainer, before, hist, fit_s = _one_fit(bs, "recovered", counts)
    xs = torch.from_numpy(np.stack([x.x for x in bs])).cuda()
    masks = torch.from_numpy(np.stack([x.mask for x in bs])).cuda()
    fit_rows = np.concatenate([x.x for x in bs])
    # the params bound from the plain version alone, before any gate
    bound = order_noise_bound(before,
                              row_orders(fit_rows, STORE_FIT_ORDERS), masks)
    err, drift = _store_fit_check(trainer, before, hist, xs, masks, bound)
    mem = Broker()
    mem.create_topic(STORE_TOPIC, partitions=STORE_PARTS)
    for tick in _store_ticks(2):
        mem.produce_many(STORE_TOPIC, tick)
    mem_bs = _store_batches(mem, "store-fit")
    _same_batches(mem_bs, bs, "the in-memory broker")
    twin, _b, twin_hist, _s = _one_fit(mem_bs, "in_memory", counts)
    _same_fit((twin, twin_hist), (trainer, hist), "the in-memory broker")

    sample = next(iter(SensorBatches(
        StreamConsumer(b, specs, group="store-threshold"), batch_size=512,
        only_normal=True)))
    threshold = float(np.percentile(anomaly.reconstruction_errors(
        CAR_AUTOENCODER, trainer.state.params,
        sample.x[:sample.n_valid]), 99.0))
    b.create_topic("model-predictions", partitions=1)
    serve_batches = SensorBatches(
        StreamConsumer(b, specs, group="store-serve"), batch_size=100,
        take=100, keep_labels=True)
    scorer = StreamScorer(
        CAR_AUTOENCODER, trainer.state.params, serve_batches,
        OutputSequence(b, "model-predictions", partition=0),
        threshold=threshold)
    with _ring_read("store_path's scorer") as ring_score:
        ring_score["batchers"].append(serve_batches)
        t0 = time.perf_counter()
        n = scorer.score_available()
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
    payloads = [m.value.decode() for m in b.fetch("model-predictions", 0,
                                                  0, 10 ** 6)]
    if n != 10_000 or len(payloads) != n:
        raise AssertionError(f"store_path scored {n}, wrote "
                             f"{len(payloads)}")
    rows = np.concatenate([x.x[:x.n_valid] for x in SensorBatches(
        StreamConsumer(b, specs, group="store-recompute"), batch_size=100,
        take=100)])
    with torch.no_grad():
        want = torch.func.functional_call(
            CAR_AUTOENCODER.build("cpu"),
            {k: v.cpu() for k, v in trainer.state.params.items()},
            (torch.from_numpy(rows),)).numpy()
    err_first, err_all, anomalies = _check_serve_payloads(
        payloads, want, rows, threshold, "store_path")
    b.close()
    b = Broker(store_dir=d)
    if [m.value.decode() for m in b.fetch("model-predictions", 0, 0,
                                          10 ** 6)] != payloads:
        raise AssertionError("store_path: model-predictions read back "
                             "after a remount differ")
    return {"broker": b, "trainer": trainer, "hist": hist, "batches": bs,
            "max_abs_err": err, "fit_start": before, "fit_rows": fit_rows,
            "bound": bound,
            "info": {"batch_seconds": batch_s, "fit_seconds": fit_s,
                     "ring_fit": ring_fit, "ring_score": ring_score,
                     "loss_first": hist["loss"][0],
                     "loss_last": hist["loss"][-1], "fit_max_abs_err": err,
                     "fit_final_params_drift": drift,
                     "params_bound": public_bound(bound),
                     "in_memory_fit_bit_equal": True, "threshold": threshold,
                     "rows_scored": n, "score_seconds": score_s,
                     "score_rows_per_s": n / score_s,
                     "payload_max_err_first_100": err_first,
                     "payload_max_err_all": err_all, "anomalies": anomalies,
                     "payloads_equal_after_remount": True}}


def _store_backfill(b, root: str, crash: dict, counts: dict) -> dict:
    """(d) ContinuousTrainer(backfill_since_ms=tick 5's ms) on the
    remounted broker: each partition starts at offset_for_timestamp and
    at the linear scan's first record; each round one B1 launch."""
    since = crash["backfill_since_ms"]
    ct = ContinuousTrainer(b, STORE_TOPIC,
                           ArtifactStore(os.path.join(root, "art")),
                           group="store-backfill", backfill_since_ms=since)
    starts = {p: off for _t, p, off in ct.consumer.positions()}
    for p in range(STORE_PARTS):
        oft = b.offset_for_timestamp(STORE_TOPIC, p, since)
        if not starts[p] == oft == crash["first_at_backfill"][p] > 0:
            raise AssertionError(f"store_path: partition {p} backfills "
                                 f"from {starts[p]}, offset_for_timestamp "
                                 f"{oft}, the scan "
                                 f"{crash['first_at_backfill'][p]}")
    seconds = []
    for r in range(STORE_BACKFILL_ROUNDS):
        launches = fused_train.fused_fit.launches
        t0 = time.perf_counter()
        if not ct.train_round():
            raise AssertionError(f"store_path: backfill round {r} empty")
        seconds.append(time.perf_counter() - t0)
        n = fused_train.fused_fit.launches - launches
        if n != 1:
            raise AssertionError(f"store_path: backfill round {r} launched "
                                 f"B1 {n}x")
    counts["backfill"] = STORE_BACKFILL_ROUNDS
    return {"since_ms": since, "starts": [starts[p]
                                          for p in range(STORE_PARTS)],
            "rounds": STORE_BACKFILL_ROUNDS, "round_seconds": seconds,
            "records_trained": ct.records_trained}


class _PureCodec:
    """``NativeCodec.decode_batch`` by the pure codec (``ops.avro``): the
    per-record leg's decoder in (h), the oracle of the ring."""

    def __init__(self, schema):
        self.schema = schema
        self.codec = AvroCodec(schema)
        self.strings = [f.name for f in schema.fields
                        if f.avro_type == "string"]
        self.n_strings = len(self.strings)
        self.n_numeric = len(schema.fields) - self.n_strings

    def decode_batch(self, values, strip: int = 0):
        cols = self.codec.decode_batch([v[strip:] for v in values])
        labels = np.zeros((len(values), max(self.n_strings, 1)),
                          f"S{native.LABEL_STRIDE}")
        for j, name in enumerate(self.strings):
            labels[:, j] = [v.encode()[:native.LABEL_STRIDE - 1]
                            for v in cols[name]]
        return self.codec.sensor_matrix(cols), labels


def _partition_rows(batches):
    """Rows, labels and keys of ``batches`` (valid rows only), grouped by
    the partition their key hashes to, in the order read."""
    x = np.concatenate([b.x[:b.n_valid] for b in batches])
    keys = np.concatenate([b.keys[:b.n_valid] for b in batches])
    labels = np.concatenate([np.asarray(b.labels[:b.n_valid], object)
                             if b.labels is not None
                             else np.full((b.n_valid,), "", object)
                             for b in batches])
    part = np.fromiter((zlib.crc32(k) % STORE_PARTS for k in keys),
                       np.int64, len(keys))
    return [(x[part == p], labels[part == p], keys[part == p])
            for p in range(STORE_PARTS)]


def _same_rows(a, b) -> bool:
    """Whether two reads hold the same rows, labels and keys in the same
    order a partition."""
    return all(np.array_equal(xa, xb) and list(la) == list(lb)
               and np.array_equal(ka, kb)
               for (xa, la, ka), (xb, lb, kb) in zip(_partition_rows(a),
                                                      _partition_rows(b)))


def _same_batch_list(a, b) -> bool:
    return len(a) == len(b) and all(
        (x.n_valid, x.first_index) == (y.n_valid, y.first_index)
        and np.array_equal(x.x, y.x) and np.array_equal(x.mask, y.mask)
        and list(x.labels) == list(y.labels)
        and np.array_equal(x.keys, y.keys) for x, y in zip(a, b))


def _log_bytes(d: str, topic: str, partition: int) -> bytes:
    root = Path(d) / "segments" / topic / str(partition)
    return b"".join(f.read_bytes() for f in sorted(root.glob("*.log")))


def _store_ring(b, root: str, crash: dict) -> dict:
    """(h) The columnar ring on the recovered window: every record read
    once through ``SensorBatches`` on the ring and once through the
    per-record leg with the pure codec (values, labels, keys, masks and
    batch boundaries equal), each timed; a replay from tick 5's
    timestamp by ``seek_to_timestamp`` + ``poll_into`` equal to the read's
    rows past each partition's cut; one tick over RAW_PRODUCE through a
    ``KafkaWireServer`` on a durable broker from the pure and the native
    client, each partition's segment bytes equal to the classic
    ``produce_many``'s; one RAW_FETCH a partition equal to ``fetch_raw``
    of the same log."""
    specs = [f"{STORE_TOPIC}:{p}:0" for p in range(STORE_PARTS)]
    stats0 = dict(native.stats)
    # at the default IOTML_RAW_BATCH_BYTES a fetch deeper than 1 MiB into
    # an appended batch (one sparse-index entry a produce_many a
    # partition, ~1.95 MB a tick here) holds only frames below the
    # cursor, and poll_into falls back a chunk to the message-list leg,
    # as the JAX package's does on the same log: counted, not failed
    with _recording(StreamConsumer, "poll") as polls:
        t0 = time.perf_counter()
        n_default = sum(x.n_valid for x in SensorBatches(
            StreamConsumer(b, specs, group="ring-default"), batch_size=100))
        default_s = time.perf_counter() - t0
    default = {"raw_batch_bytes": pipeline.raw_batch_bytes(),
               "records": n_default, "fallback_chunks": len(polls),
               "fallback_records": sum(len(c.result) for c in polls),
               "seconds": default_s,
               "records_per_s": n_default / default_s}
    # the knob past two ticks' batches, so that every fetch reaches past
    # its cursor: the ring carries every chunk from here on
    knob = os.environ.get("IOTML_RAW_BATCH_BYTES")
    pipeline.set_knobs(raw_batch_bytes=STORE_RING_BATCH_BYTES)
    try:
        return {"default_knob": default,
                **_store_ring_reads(b, root, crash, specs, stats0)}
    finally:
        if knob is None:
            os.environ.pop("IOTML_RAW_BATCH_BYTES", None)
        else:
            os.environ["IOTML_RAW_BATCH_BYTES"] = knob


def _store_ring_reads(b, root, crash, specs, stats0) -> dict:
    """(h)'s reads, replay and raw produce under STORE_RING_BATCH_BYTES."""
    with _ring_read("store_path (h)") as ring:
        sb = SensorBatches(StreamConsumer(b, specs, group="ring-read"),
                           batch_size=100, keep_labels=True, keep_keys=True)
        ring["batchers"].append(sb)
        t0 = time.perf_counter()
        cols = list(sb)
        ring_s = time.perf_counter() - t0
    def per_record(spec_list, group):
        sb = SensorBatches(StreamConsumer(b, spec_list, group=group),
                           batch_size=100, keep_labels=True, keep_keys=True)
        sb._ring, sb._native = False, _PureCodec(KSQL_CAR_SCHEMA)
        return sb

    t0 = time.perf_counter()
    recs = list(per_record(specs, "record-read"))
    rec_s = time.perf_counter() - t0
    rows = sum(x.n_valid for x in cols)
    # over 10 cursors the interleaving of partitions follows each leg's
    # fetches (the ring's are bounded in bytes and by a segment's end),
    # so the two reads hold the same rows in the same order a partition;
    # over one cursor their batches are equal outright
    if rows != crash["served"] or sum(x.n_valid for x in recs) != rows \
            or not _same_rows(cols, recs):
        raise AssertionError(f"store_path (h): the ring's {rows} rows "
                             f"(of {crash['served']}) differ from the "
                             f"per-record leg's, a partition")
    interleaved = sum(not _same_batch_list([x], [y])
                      for x, y in zip(cols, recs))
    del recs
    with _ring_read("store_path (h), partition 0") as ring0:
        sb0 = SensorBatches(StreamConsumer(b, specs[:1], group="ring-p0"),
                            batch_size=100, keep_labels=True, keep_keys=True)
        ring0["batchers"].append(sb0)
        cols0 = list(sb0)
    if not _same_batch_list(cols0, list(per_record(specs[:1],
                                                   "record-p0"))):
        raise AssertionError("store_path (h): partition 0's batches differ "
                             "between the ring and the per-record leg")

    # replay from tick 5's timestamp: seek_to_timestamp + poll_into
    consumer = StreamConsumer(b, specs, group="ring-replay")
    consumer.seek_to_timestamp(crash["backfill_since_ms"])
    dec = native.NativeCodec(KSQL_CAR_SCHEMA).frame_decoder()
    cap = 4096
    x = np.zeros((cap, dec.n_numeric), np.float32)
    lab = np.zeros((cap, dec.n_strings), f"S{native.LABEL_STRIDE}")
    keys = np.zeros((cap,), f"S{native.KEY_STRIDE}")
    got_x, got_k = [], []
    t0 = time.perf_counter()
    while True:
        n, fallback = consumer.poll_into(
            dec, x, lab, keys, max_rows=cap,
            max_bytes=pipeline.raw_batch_bytes())
        if fallback:
            raise AssertionError("store_path (h): the replay fell back")
        if not n:
            break
        got_x.append(CAR_NORMALIZER.np(x[:n]))
        got_k.append(keys[:n].copy())
    replay_s = time.perf_counter() - t0
    replayed = Batch(np.concatenate(got_x), sum(map(len, got_x)), 0,
                     keys=np.concatenate(got_k))
    for p, ((want_x, _wl, _wk), (rx, _rl, _rk)) in enumerate(zip(
            _partition_rows(cols), _partition_rows([replayed]))):
        cut = crash["first_at_backfill"][p]
        if not np.array_equal(rx, want_x[cut:]):
            raise AssertionError(f"store_path (h): partition {p}'s replay "
                                 f"from offset {cut} differs from the read")
    del cols

    # one tick over RAW_PRODUCE, pure and native clients, vs classic
    tick = next(_store_ticks(1))
    by_part = [[] for _ in range(STORE_PARTS)]
    for e in tick:
        by_part[zlib.crc32(e[0]) % STORE_PARTS].append(e)
    out = {}
    dirs = {kind: os.path.join(root, f"raw-{kind}")
            for kind in ("classic", "pure", "native")}
    classic = Broker(store_dir=dirs["classic"])
    classic.create_topic(STORE_TOPIC, partitions=STORE_PARTS)
    t0 = time.perf_counter()
    classic.produce_many(STORE_TOPIC, tick)
    out["classic_produce_many_records_per_s"] = \
        len(tick) / (time.perf_counter() - t0)
    classic.close()
    cap_bytes = pipeline.produce_batch_bytes()
    for kind in ("pure", "native"):
        rb = Broker(store_dir=dirs[kind])
        rb.create_topic(STORE_TOPIC, partitions=STORE_PARTS)
        server = KafkaWireServer(rb).start()
        client = (KafkaWireBroker if kind == "pure" else NativeKafkaBroker)(
            f"127.0.0.1:{server.port}")
        try:
            producer = RawBatchProducer(client, STORE_TOPIC, mode="on")
            requests = 0
            t0 = time.perf_counter()
            for p, ents in enumerate(by_part):
                start = size = 0
                for i, e in enumerate(ents + [None]):
                    grow = native.FRAME_OVERHEAD + len(e[0]) + len(e[1]) \
                        if e is not None else 0
                    if e is None or (size + grow > cap_bytes and i > start):
                        chunk = ents[start:i]
                        producer.produce_frames(p, frame_entries(chunk),
                                                len(chunk))
                        requests += 1
                        start, size = i, 0
                    size += grow
            raw_s = time.perf_counter() - t0
            fetched = [client.fetch_raw(STORE_TOPIC, p, 0)
                       if kind == "pure" else None
                       for p in range(STORE_PARTS)]
        finally:
            client.close()
            server.shutdown()
            server.server_close()
        if kind == "pure" and any(
                f is None or f.data != rb.fetch_raw(STORE_TOPIC, p, 0).data
                for p, f in enumerate(fetched)):
            raise AssertionError("store_path (h): a RAW_FETCH differs from "
                                 "fetch_raw of the same log")
        rb.close()
        if any(_log_bytes(dirs[kind], STORE_TOPIC, p)
               != _log_bytes(dirs["classic"], STORE_TOPIC, p)
               for p in range(STORE_PARTS)):
            raise AssertionError(f"store_path (h): the {kind} client's "
                                 f"RAW_PRODUCE segments differ from the "
                                 f"classic produce_many's")
        out[f"raw_produce_{kind}"] = {
            "records": len(tick), "requests": requests, "seconds": raw_s,
            "records_per_s": len(tick) / raw_s}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    stats = {k: native.stats[k] - stats0[k] for k in native.stats
             if k.startswith("frame_")}
    return {"raw_batch_bytes": pipeline.raw_batch_bytes(),
            "records": rows, "ring": ring, "ring_seconds": ring_s,
            "ring_records_per_s": rows / ring_s,
            "per_record_pure_codec_seconds": rec_s,
            "per_record_pure_codec_records_per_s": rows / rec_s,
            "rows_equal_a_partition": True,
            "batches_interleaved_otherwise": interleaved,
            "batches_of_one_cursor_equal": len(cols0),
            "replay_since_ms": crash["backfill_since_ms"],
            "replay_records": replayed.n_valid, "replay_seconds": replay_s,
            "replay_records_per_s": replayed.n_valid / replay_s,
            "replay_equal_read": True, **out,
            "raw_produce_segments_equal_classic": True,
            "raw_fetch_equal_fetch_raw": True, "native_frame_stats": stats}


def _store_compaction(root: str) -> dict:
    """(e) The window again on a cleanup_policy="compact" topic: 100,000
    car keys × 10 updates on 1 MiB segments, then a tombstone for one car
    in 1,000; every partition rolled, one forced pass; exactly the newest
    record per key survives at its original offset (a dict reference),
    the tombstones inside the grace window among them."""
    d = os.path.join(root, "compact")
    b = Broker(store_dir=d, store_policy=StorePolicy(
        segment_bytes=STORE_COMPACT_SEGMENT))
    topic = "CAR_STATE"
    b.create_topic(topic, partitions=STORE_PARTS, cleanup_policy="compact")
    newest, counters = {}, [0] * STORE_PARTS
    append_s = 0.0

    def publish(entries):
        nonlocal append_s
        for k, v, ts in entries:
            p = zlib.crc32(k) % STORE_PARTS
            newest[k] = (counters[p], v, ts)
            counters[p] += 1
        t0 = time.perf_counter()
        b.produce_many(topic, entries)
        append_s += time.perf_counter() - t0

    tick = None
    for tick in _store_ticks(STORE_TICKS):
        publish(tick)
    dead = [(k, None, tick[0][2] + 1) for k, _v, _t
            in tick[::STORE_TOMBSTONE_EVERY]]
    publish(dead)
    logs = [b.store.log_for(topic, p) for p in range(STORE_PARTS)]
    for log in logs:
        log.roll()
    before = sum(log.total_bytes() for log in logs)
    segments = sum(len(log._segments) for log in logs)
    t0 = time.perf_counter()
    stats = b.run_compaction(force=True)
    compact_s = time.perf_counter() - t0
    after = sum(log.total_bytes() for log in logs)
    got = {}
    for log in logs:
        for s in log._segments:
            for _p, _e, off, key, value, ts, _h in \
                    store_segment.iter_frames(s.path, 0):
                if key in got:
                    raise AssertionError(f"store_path: key {key!r} "
                                         f"survived compaction twice")
                got[key] = (off, value, ts)
    if got != newest:
        raise AssertionError(f"store_path: compaction left {len(got)} keys, "
                             f"not the {len(newest)} newest records")
    tombstones = sum(1 for _o, v, _t in got.values() if v is None)
    if tombstones != len(dead):
        raise AssertionError(f"store_path: {tombstones} tombstones kept of "
                             f"{len(dead)}")
    reclaimed = sum(s.bytes_reclaimed for s in stats.values())
    if reclaimed != before - after:
        raise AssertionError(f"store_path: reclaimed {reclaimed} of "
                             f"{before - after} bytes")
    b.close()
    shutil.rmtree(d, ignore_errors=True)
    records = STORE_CARS * STORE_TICKS + len(dead)
    return {"records": records, "keys": len(newest), "tombstones": len(dead),
            "append_s": append_s, "append_records_per_s": records / append_s,
            "segments": segments, "bytes_before": before,
            "bytes_after": after, "bytes_reclaimed": reclaimed,
            "records_removed": sum(s.records_removed
                                   for s in stats.values()),
            "pass_seconds": compact_s,
            "pass_records_per_s": records / compact_s,
            "pass_mb_per_s": before / compact_s / 1e6}


def _store_tier(b, d: str, root: str, fit, counts: dict) -> dict:
    """(f) D remounted with a remote tier whose hot budget is one segment:
    one tiering pass uploads every sealed segment and evicts the head, so
    the fit's batches come through the remote tier; they equal (c)'s
    exactly and one B1 launch gives (c)'s fit bit for bit."""
    b.close()
    seg_bytes = StorePolicy().segment_bytes
    bucket = os.path.join(root, "bucket")
    tb = Broker(store_dir=d, tier=TierPolicy(uri=bucket,
                                             local_hot_bytes=seg_bytes))
    try:
        t0 = time.perf_counter()
        stats = tb.run_tiering()
        tier_s = time.perf_counter() - t0
        logs = [tb.store.log_for(STORE_TOPIC, p) for p in range(STORE_PARTS)]
        if not all(log.local_base_offset > 0 and log.base_offset == 0
                   for log in logs):
            raise AssertionError("store_path: the hot tier still holds the "
                                 "head, or the log lost it")
        uploaded = sum(s["bytes"] for s in stats.values())
        remote = obs_metrics.default_registry.counter(
            "iotml_tier_remote_records_total")
        r0 = remote.value()
        t0 = time.perf_counter()
        tbs = _store_batches(tb, "store-fit")
        first_read_s = time.perf_counter() - t0
        _same_batches(tbs, fit["batches"], "the tiered log")
        trainer, _b, hist, fit_s = _one_fit(tbs, "tiered", counts)
        _same_fit((trainer, hist), (fit["trainer"], fit["hist"]),
                  "the tiered log")
        # a warm read of partition 0's remote range: the cached segment
        t0 = time.perf_counter()
        warm = tb.fetch(STORE_TOPIC, 0, 0, logs[0].local_base_offset)
        warm_s = time.perf_counter() - t0
        if len(warm) != logs[0].local_base_offset:
            raise AssertionError("store_path: the remote range is short")
        return {"tiering_pass_s": tier_s,
                "segments_uploaded": sum(s["uploaded"]
                                         for s in stats.values()),
                "upload_bytes": uploaded,
                "upload_mb_per_s": uploaded / tier_s / 1e6,
                "evicted_bytes": sum(s["evicted"] for s in stats.values()),
                "local_base_offsets": [log.local_base_offset
                                       for log in logs],
                "first_read_s": first_read_s,
                "remote_records_first_read": remote.value() - r0,
                "warm_remote_read_records": len(warm),
                "warm_remote_read_records_per_s": len(warm) / warm_s,
                "fit_seconds": fit_s, "fit_bit_equal_recovered": True}
    finally:
        tb.close()


def _store_platform(root: str, counts: dict) -> dict:
    """(g) Platform(store_dir=D2) on the card: one tick of
    STORE_PLATFORM_CARS cars over MQTT (64 connections, one publish_many
    each) into the bridge and KSQL, stopped; a second Platform on D2
    re-serves SENSOR_DATA_S_AVRO whole and B1 fits on it."""
    d = os.path.join(root, "platform")
    scenario = FleetScenario(num_cars=STORE_PLATFORM_CARS, failure_rate=0.01)
    gen = FleetGenerator(scenario)
    cols = gen.step_columns()
    tick = [(scenario.car_id(i), _bridge_key(scenario, i).decode(),
             json.dumps(gen.row_record(cols, i, KSQL_CAR_SCHEMA)).encode())
            for i in range(STORE_PLATFORM_CARS)]
    plat = Platform(store_dir=d)
    plat.ksql.pump_interval_s = 3600.0  # pump_now alone drives the pump
    plat.start()
    try:
        front = _mqtt_publish_tick(plat.mqtt.port, tick, plat.mqtt,
                                   plat.bridge.forwarded, batched=True)
        while plat.pump():
            pass
        avro = plat.broker.topic("SENSOR_DATA_S_AVRO").partitions
        before = [[(m.offset, m.key, m.value, m.timestamp_ms) for m in
                   plat.broker.fetch("SENSOR_DATA_S_AVRO", p, 0, 10 ** 7)]
                  for p in range(avro)]
    finally:
        plat.stop()
    if sum(map(len, before)) != STORE_PLATFORM_CARS:
        raise AssertionError(f"store_path: the platform's KSQL leg holds "
                             f"{sum(map(len, before))} records")
    t0 = time.perf_counter()
    plat = Platform(store_dir=d).start()
    restart_s = time.perf_counter() - t0
    try:
        again = [[(m.offset, m.key, m.value, m.timestamp_ms) for m in
                  plat.broker.fetch("SENSOR_DATA_S_AVRO", p, 0, 10 ** 7)]
                 for p in range(avro)]
        if again != before:
            raise AssertionError("store_path: the restarted platform does "
                                 "not re-serve SENSOR_DATA_S_AVRO")
        bs = _store_batches(plat.broker, "store-platform",
                            "SENSOR_DATA_S_AVRO")
        _t, _b, hist, fit_s = _one_fit(bs, "platform", counts)
        if not np.isfinite(hist["loss"]).all():
            raise AssertionError("store_path: the platform's fit diverged")
    finally:
        plat.stop()
    return {"cars": STORE_PLATFORM_CARS, "publish": front,
            "avro_partitions": avro, "restart_s": restart_s,
            "fit_seconds": fit_s, "loss_first": hist["loss"][0],
            "loss_last": hist["loss"][-1]}


def phase_store_path(card: str) -> dict:
    """The durable commit log under the main path: (a) append, (b) crash
    and recovery, (c) B1 and the scorer from the recovered log, (d)
    backfill, (e) compaction, (f) the tiered log, (g) the durable
    platform."""
    reset_launches()
    reset_fit_launches()
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    counts: dict = {}
    b = None
    try:
        append = _store_append(root)
        d = append.pop("dir")
        crash = _store_crash(d)
        b = crash.pop("broker")
        fit = _store_fit_and_score(b, d, counts)
        b = fit.pop("broker")
        backfill = _store_backfill(b, root, crash, counts)
        ring = _store_ring(b, root, crash)
        compaction = _store_compaction(root)
        tier = _store_tier(b, d, root, fit, counts)
        b = None
        platform = _store_platform(root, counts)
    finally:
        if b is not None:
            b.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if launches != sum(counts.values()) or by_design["rows"] != launches:
        raise AssertionError(f"store_path launched B1 {launches}x "
                             f"({by_design}), sub-phases say {counts}")
    attention = {k: v for k, v in path_launches().items() if k != "fused_fit"}
    if any(attention.values()):
        raise AssertionError(f"store_path launched {attention}")
    crash.pop("first_at_backfill")
    emit({"phase": "store_path", "card": card, "cars": STORE_CARS,
          "ticks": STORE_TICKS, "partitions": STORE_PARTS,
          "retention_ms": STORE_RETENTION_MS, "append": append,
          "crash": crash, **fit["info"], "backfill": backfill,
          "compaction": compaction, "tier": tier, "platform": platform,
          "ring": ring,
          "kernel_launches": launches, "kernel_launches_by_design": by_design,
          "kernel_launches_by_subphase": counts})
    return {"launches": launches, "launches_by_design": by_design,
            "by_subphase": counts, "max_abs_err": fit["max_abs_err"],
            **{k: fit[k] for k in ("fit_start", "fit_rows", "bound")}}


#: replication_path: the reference's RF-3 topics (leader + 2 followers,
#: 01_installConfluentPlatform.sh:180-183) on the platform's 10 partitions
REPL_FOLLOWERS, REPL_MIN_ISR, REPL_MAX_LAG_S = 2, 2, 0.5
REPL_RUNS = 3
REPL_TIMEOUT_MS = 30_000


def _repl_chunks(tick, parts: int) -> list:
    """A tick as RAW_PRODUCE requests: (partition, frames, entries), each
    partition's records (by key, as the producer partitions them) cut at
    ``IOTML_PRODUCE_BATCH_BYTES``."""
    by_part = [[] for _ in range(parts)]
    for e in tick:
        by_part[zlib.crc32(e[0]) % parts].append(e)
    cap = pipeline.produce_batch_bytes()
    out = []
    for p, ents in enumerate(by_part):
        start = size = 0
        for i, e in enumerate(ents + [None]):
            grow = native.FRAME_OVERHEAD + len(e[0]) + len(e[1]) \
                if e is not None else 0
            if e is None or (size + grow > cap and i > start):
                chunk = ents[start:i]
                out.append((p, frame_entries(chunk), chunk))
                start, size = i, 0
            size += grow
    return out


def _repl_publish(addr: str, acks: int, chunks, acked: list) -> float:
    """Ship ``chunks`` through one raw producer at ``acks``; each acked
    chunk's (partition, base, entries) joins ``acked``.  Seconds."""
    client = KafkaWireBroker(addr, acks=acks, client_id="smoke-repl")
    producer = RawBatchProducer(client, STORE_TOPIC, mode="on")
    try:
        t0 = time.perf_counter()
        for p, frames, ents in chunks:
            base = producer.produce_frames(p, frames, len(ents))
            acked.append((p, base, ents))
        return time.perf_counter() - t0
    finally:
        client.close()


def _repl_cli_fit(addr: str, root: str, where: str) -> dict:
    """cardata ``train`` against ``addr`` on the card: one B1 launch, its
    checkpoint and the group's committed cursors."""
    before = fused_train.fused_fit.launches
    rows = fused_train.fused_fit.launches_by_design["rows"]
    train = _run_cli("train", root, addr)
    if train["stats"]["broker"] != "wire" or \
            fused_train.fused_fit.launches != before + 1 or \
            fused_train.fused_fit.launches_by_design["rows"] != rows + 1:
        raise AssertionError(f"replication_path ({where}): the CLI fit "
                             f"launched B1 "
                             f"{fused_train.fused_fit.launches - before}x "
                             f"on {train['stats']['broker']}, not once "
                             f"through rows over the wire")
    ckpt = CheckpointManager.load_dir(ArtifactStore(root).download_tree(
        "m1", str(Path(root) / "restored")))
    return {"stats": train["stats"], "seconds": train["seconds"],
            "ckpt": ckpt}


def _repl_same_ckpt(a: dict, b: dict) -> None:
    for tree in ("params", "mu", "nu"):
        ta = a["params"] if tree == "params" \
            else getattr(a["opt_state"], tree)
        tb = b["params"] if tree == "params" \
            else getattr(b["opt_state"], tree)
        for k in PARAM_NAMES:
            if not torch.equal(ta[k], tb[k]):
                raise AssertionError(f"replication_path (f): {tree}/{k} of "
                                     f"the fit from the promoted replica "
                                     f"differs from the pre-kill fit")
    if (a["step"], a["cursors"]) != (b["step"], b["cursors"]):
        raise AssertionError(f"replication_path (f): step/cursors "
                             f"{a['step']} {a['cursors']} vs "
                             f"{b['step']} {b['cursors']}")


def _repl_plain_check(addr: str, fit: dict) -> float:
    """The promoted fit against the plain version: the CLI's batches,
    rebuilt from offset 0 of the promoted log (they must end at the
    checkpoint's cursors), from the CLI's start state (seed 0); every
    epoch's loss and the final Adam moments at the fit bounds, the step
    count.  Returns the largest absolute difference."""
    cfg = cli_app.load_config([])[0]
    trainer = Trainer(CAR_AUTOENCODER, learning_rate=cfg.train.learning_rate)
    trainer._ensure_state()
    client = KafkaWireBroker(addr, client_id="smoke-repl-check")
    try:
        parts = cli_app.topic_partitions(client, STORE_TOPIC)
        consumer = StreamConsumer(client, [f"{STORE_TOPIC}:{p}:0"
                                           for p in parts],
                                  group="smoke-repl-check")
        bs = list(SensorBatches(consumer, batch_size=cardata.BATCH_SIZE,
                                take=cardata.TAKE_BATCHES,
                                only_normal=cfg.train.only_normal))
        if [tuple(c) for c in consumer.positions()] != \
                [tuple(c) for c in fit["ckpt"]["cursors"]]:
            raise AssertionError("replication_path (f): the rebuilt "
                                 "batches end elsewhere than the CLI's")
    finally:
        client.close()
    xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
    plain, losses, _accs = fused_train.fused_fit_reference(
        trainer.state, xs, masks, cardata.NB_EPOCH,
        cfg.train.learning_rate, CAR_AUTOENCODER.activity_l1)
    ck = fit["ckpt"]
    err = check_close("replication_path losses",
                      torch.tensor(fit["stats"]["loss"]), losses,
                      **METRIC_TOL)
    for tree in ("mu", "nu"):
        for k in PARAM_NAMES:
            err = max(err, check_close(
                f"replication_path {tree} {k}",
                getattr(ck["opt_state"], tree)[k],
                getattr(plain.opt_state, tree)[k], **STATE_TOL))
    steps = xs.shape[0] * cardata.NB_EPOCH
    if (ck["step"], ck["opt_state"].count) != (steps, steps):
        raise AssertionError(f"replication_path (f): step/count "
                             f"{ck['step']}/{ck['opt_state'].count}, not "
                             f"{steps}")
    return err


def _repl_logs_equal(acked: list, new_dir: str, old_dir: str) -> dict:
    """(e) Every acked record at its offset, byte for byte: each
    partition's log on the new leader equals the frames of what was
    acked there (in offset order, gap-free from 0) and the old leader's
    log."""
    by_part: dict = collections.defaultdict(list)
    for p, base, ents in acked:
        by_part[p].append((base, ents))
    records = 0
    for p, runs in sorted(by_part.items()):
        runs.sort(key=lambda r: r[0])
        want, off = [], 0
        for base, ents in runs:
            if base != off:
                raise AssertionError(f"replication_path (e): partition "
                                     f"{p}'s acks leave a gap at {off}")
            want.append(frame_entries(ents, base))
            off += len(ents)
            records += len(ents)
        got = _log_bytes(new_dir, STORE_TOPIC, p)
        if got != b"".join(want):
            raise AssertionError(f"replication_path (e): partition {p} on "
                                 f"the new leader differs from its acked "
                                 f"records")
        if got != _log_bytes(old_dir, STORE_TOPIC, p):
            raise AssertionError(f"replication_path (e): partition {p} on "
                                 f"the new leader differs from the old "
                                 f"leader's log")
    return {"acked_records": records, "partitions": len(by_part),
            "lost": 0, "byte_identical": True}


def _repl_fenced(old_leader, epoch: int) -> dict:
    """(e) The old leader's broker served again at its stale epoch 0: a
    current-epoch client's produce, raw produce and commit answer FENCED
    (74), nothing appended or committed."""
    from iotml_torch.stream.kafka_wire import FencedEpochError

    ends = [old_leader.end_offset(STORE_TOPIC, p)
            for p in range(STORE_PARTS)]
    zombie = KafkaWireServer(old_leader, epoch=0).start()
    fenced = []
    try:
        client = KafkaWireBroker(f"127.0.0.1:{zombie.port}", epoch=epoch,
                                 client_id="smoke-zombie-probe")
        for what, call in (
                ("produce", lambda: client.produce_many(
                    STORE_TOPIC, [(b"k", b"split-brain", 0)], partition=0)),
                ("produce_raw", lambda: client.produce_raw(
                    STORE_TOPIC, 0, frame_entries([(b"k", b"raw", 0)]))),
                ("commit", lambda: client.commit("smoke-zombie",
                                                 STORE_TOPIC, 0, 1))):
            try:
                call()
            except FencedEpochError:
                fenced.append(what)
        client.close()
    finally:
        zombie.shutdown()
        zombie.server_close()
    if fenced != ["produce", "produce_raw", "commit"] or ends != [
            old_leader.end_offset(STORE_TOPIC, p)
            for p in range(STORE_PARTS)] or \
            old_leader.committed("smoke-zombie", STORE_TOPIC, 0) is not None:
        raise AssertionError(f"replication_path (e): the resurrected old "
                             f"leader fenced only {fenced}")
    return {"fenced": fenced, "error": 74}


def _repl_drills() -> dict:
    """(g) Both drill CLIs in-process at their defaults; B1 launches of
    each supervise drill (the leader-kill trainer's)."""
    from iotml_torch.replication.__main__ import main as repl_main
    from iotml_torch.supervise import drill as sup_drill
    from iotml_torch.supervise.__main__ import main as sup_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = repl_main(["drill", "--name", "double-fault"])
    repl_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"replication drill double-fault exited {rc}:"
                             f"\n{err.getvalue()}")
    repl = json.loads(out.getvalue())
    real = dict(sup_drill.DRILLS)
    launches: dict = {}

    def counted(name, fn):
        def run(**kw):
            before = fused_train.fused_fit.launches
            rows = fused_train.fused_fit.launches_by_design["rows"]
            report = fn(**kw)
            n = fused_train.fused_fit.launches - before
            if fused_train.fused_fit.launches_by_design["rows"] - rows != n:
                raise AssertionError(f"drill {name}: B1 off the rows "
                                     f"design")
            launches[name] = n
            return report
        run.__doc__ = fn.__doc__
        return run

    sup_drill.DRILLS.update({n: counted(n, f) for n, f in real.items()})
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = sup_main(["drill", "--all", "--json"])
    finally:
        sup_drill.DRILLS.update(real)
    sup_s = time.perf_counter() - t0
    # --json prints one indented document a drill, each opening at a
    # line's start
    reports = [json.loads("{" + doc) for doc in
               out.getvalue().strip().lstrip("{").split("\n{")]
    if rc != 0:
        raise AssertionError(f"supervise drill --all exited {rc}: "
                             f"{[(r['drill'], r['ok']) for r in reports]}")
    if launches.get("leader-kill", 0) < 1 or any(
            n for d, n in launches.items() if d != "leader-kill"):
        raise AssertionError(f"supervise drills' B1 launches {launches}: "
                             f"the leader-kill trainer fits, nothing else")
    return {"double_fault": {"ok": repl["ok"], "slos": repl["slos"],
                             "seconds": repl_s,
                             "invariants": [i["name"] for i in
                                            repl["invariants"]]},
            "supervise": {r["drill"]: {"ok": r["ok"], "slos": r["slos"],
                                       "restarts": r["restarts"]}
                          for r in reports},
            "supervise_seconds": sup_s, "b1_launches_by_drill": launches}


def phase_replication_path(card: str, root: str) -> dict:
    """Replicated durability under the main path: (a) the replica set,
    (b) the load, (c) acks=all vs acks=1, (d) the double fault, (e) the
    checks, (f) the fit from the promoted replica, (g) the drills."""
    from iotml_torch.replication import ReplicaSet
    from iotml_torch.store.hwm import HwmFile
    from iotml_torch.supervise.topology import Topology

    reset_launches()
    reset_fit_launches()
    t_phase = time.perf_counter()
    base = Path(root) / "replication"
    dirs = {"leader": str(base / "leader")}
    dirs.update({f"follower{i}": str(base / f"follower{i}")
                 for i in range(REPL_FOLLOWERS + 1)})
    made = iter(range(REPL_FOLLOWERS + 1))

    def follower_log():
        return Broker(store_dir=dirs[f"follower{next(made)}"])

    # (a) the replica set
    leader = Broker(store_dir=dirs["leader"])
    leader.create_topic(STORE_TOPIC, partitions=STORE_PARTS)
    lsrv = KafkaWireServer(leader, epoch=0).start()
    laddr = f"127.0.0.1:{lsrv.port}"
    topo = Topology(laddr, epoch=0)
    rs = ReplicaSet(leader_broker=leader, leader_server=lsrv,
                    n_followers=REPL_FOLLOWERS, min_isr=REPL_MIN_ISR,
                    max_lag_s=REPL_MAX_LAG_S, topics=[STORE_TOPIC],
                    topology=topo, follower_local_factory=follower_log,
                    hwm_file=HwmFile(dirs["leader"]))
    counts: dict = {}
    acked: list = []
    killed = False
    try:
        rs.start(sync="thread")
        t0 = time.perf_counter()
        if not all(rs.await_isr(1 + REPL_FOLLOWERS, STORE_TOPIC, p,
                                timeout_s=30) for p in range(STORE_PARTS)):
            raise AssertionError("replication_path (a): the ISR never "
                                 "formed")
        form_s = time.perf_counter() - t0

        # (b) the load and (c) acks=all vs acks=1, in turns
        t0 = time.perf_counter()
        chunks = _repl_chunks(next(_store_ticks(1)), STORE_PARTS)
        encode_s = time.perf_counter() - t0
        secs = {-1: [], 1: []}
        for _ in range(REPL_RUNS):
            for acks in (-1, 1):
                secs[acks].append(_repl_publish(laddr, acks, chunks, acked))
        n = sum(len(c[2]) for c in chunks)
        rates = {"acks_all": [n / s for s in secs[-1]],
                 "acks_1": [n / s for s in secs[1]]}
        med = {k: float(np.median(v)) for k, v in rates.items()}
        if not rs.caught_up(timeout_s=60):
            raise AssertionError("replication_path (c): followers never "
                                 "caught up")
        counts["prekill_cli_fit"] = 1
        pre = _repl_cli_fit(laddr, str(base / "fit-pre"), "pre-kill")

        # (d) the double fault
        dead = sorted(rs.followers)[0]
        rs.kill_follower(dead)
        t0 = time.perf_counter()
        reform = [next(c for c in chunks if c[0] == p)
                  for p in range(STORE_PARTS)]
        client = KafkaWireBroker(laddr, acks=-1, client_id="smoke-reform")
        try:
            for p, frames, ents in reform:
                b0 = client.produce_raw(STORE_TOPIC, p, frames,
                                        timeout_ms=REPL_TIMEOUT_MS)
                acked.append((p, b0, ents))
        finally:
            client.close()
        reform_s = time.perf_counter() - t0
        isr_at_kill = sorted(rs.state.isr_follower_ids())
        if dead in isr_at_kill or not isr_at_kill:
            raise AssertionError(f"replication_path (d): ISR {isr_at_kill} "
                                 f"after follower {dead} died")
        t_kill = time.perf_counter()
        lsrv.kill()
        killed = True
        rid, addr = rs.promote(topo.epoch + 1)
        topo.publish(addr, topo.epoch + 1)
        promote_s = time.perf_counter() - t_kill
        if rid not in isr_at_kill:
            raise AssertionError(f"replication_path (d): promoted {rid}, "
                                 f"not an ISR member of {isr_at_kill}")
        new_dir = rs.leader.store.dir

        # (e) the checks
        logs = _repl_logs_equal(acked, new_dir, dirs["leader"])
        fence = _repl_fenced(leader, topo.epoch)

        # (f) the fit from the promoted replica, then a new follower
        counts["promoted_cli_fit"] = 1
        post = _repl_cli_fit(addr, str(base / "fit-post"), "promoted")
        _repl_same_ckpt(post["ckpt"], pre["ckpt"])
        err = _repl_plain_check(addr, post)
        rs.retire_follower(dead)
        t0 = time.perf_counter()
        new_rid = rs.add_follower(store_dir=dirs[f"follower{REPL_FOLLOWERS}"],
                                  sync="thread")
        # admitted on EVERY partition: the ISR tracks a partition from
        # its first fetch, so one caught-up partition alone proves little
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                new_rid in rs.state.isr_follower_ids() and
                all(rs.state.isr_size(STORE_TOPIC, p) == 2
                    for p in range(STORE_PARTS))):
            time.sleep(0.005)
        catch_up_s = time.perf_counter() - t0
        if new_rid not in rs.state.isr_follower_ids(STORE_TOPIC) or any(
                rs.state.isr_size(STORE_TOPIC, p) != 2
                for p in range(STORE_PARTS)):
            raise AssertionError("replication_path (f): the added follower "
                                 "never joined the ISR")
        mirrored = rs.followers[new_rid].raw_mirrored
        log_bytes = sum(len(_log_bytes(new_dir, STORE_TOPIC, p))
                        for p in range(STORE_PARTS))
        if mirrored != logs["acked_records"]:
            raise AssertionError(f"replication_path (f): the added follower "
                                 f"mirrored {mirrored} records over "
                                 f"RAW_FETCH, not {logs['acked_records']}")
    finally:
        rs.stop()
        if not killed:
            lsrv.kill()
        leader.close()
    launches_before_drills = fused_train.fused_fit.launches

    # (g) the drills
    drills = _repl_drills()
    counts["leader_kill_trainer"] = \
        drills["b1_launches_by_drill"]["leader-kill"]
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if launches != sum(counts.values()) or by_design["rows"] != launches \
            or launches_before_drills != 2:
        raise AssertionError(f"replication_path launched B1 {launches}x "
                             f"({by_design}), sub-phases say {counts}")
    attention = {k: v for k, v in path_launches().items() if k != "fused_fit"}
    if any(attention.values()):
        raise AssertionError(f"replication_path launched {attention}")
    shutil.rmtree(base, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "replication_path", "card": card, "cars": STORE_CARS,
          "partitions": STORE_PARTS, "followers": REPL_FOLLOWERS,
          "min_isr": REPL_MIN_ISR, "max_lag_s": REPL_MAX_LAG_S,
          "isr_form_s": form_s, "encode_s": encode_s,
          "requests_a_tick": len(chunks),
          "acks_all_records_per_s": rates["acks_all"],
          "acks_1_records_per_s": rates["acks_1"],
          "acks_all_median_records_per_s": med["acks_all"],
          "acks_1_median_records_per_s": med["acks_1"],
          "acks_all_overhead": med["acks_1"] / med["acks_all"] - 1.0,
          "reform_acks_all_s": reform_s, "isr_at_leader_kill": isr_at_kill,
          "promoted_replica": rid, "time_to_promote_s": promote_s,
          **logs, "old_leader": fence,
          "fit": {"prekill_seconds": pre["seconds"],
                  "promoted_seconds": post["seconds"],
                  "records": post["stats"]["records"],
                  "loss": post["stats"]["loss"][-1],
                  "bit_equal_prekill": True, "max_abs_err_vs_plain": err},
          "add_follower": {"catch_up_s": catch_up_s,
                           "records": mirrored, "bytes": log_bytes,
                           "mb_per_s": log_bytes / 1e6 / catch_up_s},
          "drills": drills, "phase_seconds": phase_s,
          "kernel_launches": launches, "kernel_launches_by_design": by_design,
          "kernel_launches_by_subphase": counts})
    return {"launches": launches, "launches_by_design": by_design,
            "by_subphase": counts, "max_abs_err": err}


#: cluster_path: the reference's deployment, 2 topics x 10 partitions x RF 3
#: on 3 brokers (SURVEY.md:342; 01_installConfluentPlatform.sh:180-183,
#: gcp.yaml:46-54), through the cluster's own command line
CLUSTER_BROKERS, CLUSTER_PARTS, CLUSTER_RF, CLUSTER_MIN_ISR = 3, 10, 3, 2
CLUSTER_TOPICS = (STORE_TOPIC, "model-predictions")
CLUSTER_CMD = [sys.executable, "-m", "iotml_torch.cluster"]
#: records a produce call: tick 1's, and tick 2's with the pause
#: between its calls until both moves are done (the load spans the moves)
CLUSTER_TICK_CHUNK, CLUSTER_CHUNK, CLUSTER_PACE_S = 20_000, 2_500, 0.1
CLUSTER_FLEET = 3
#: the fleet's first payloads held against a CPU recompute
CLUSTER_CHECKED_PAYLOADS = 10_000


def _cluster_up(store_root: str):
    """(a) ``python -m iotml_torch.cluster up`` as a child: its bootstrap
    line, and a reader thread draining its output."""
    proc = subprocess.Popen(
        CLUSTER_CMD + ["up", "--brokers", str(CLUSTER_BROKERS),
                       "--partitions", str(CLUSTER_PARTS),
                       "--replication-factor", str(CLUSTER_RF),
                       "--min-isr", str(CLUSTER_MIN_ISR),
                       "--topics", ",".join(CLUSTER_TOPICS),
                       "--store-root", store_root],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(Path(__file__).parent))
    lines: "queue.Queue" = queue.Queue()
    seen: list = []

    def read():
        for line in proc.stdout:
            seen.append(line)
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            continue
        if line is None:
            break
        if line.strip().startswith("bootstrap"):
            return proc, line.split()[-1], seen
    proc.kill()
    proc.wait()
    raise AssertionError(f"cluster_path (a): `cluster up` printed no "
                         f"bootstrap line:\n{''.join(seen)}")


def _cluster_stop(proc, seen: list) -> None:
    """SIGINT, as an operator's Ctrl-C: the child stops the cluster and
    exits 0."""
    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("cluster_path: `cluster up` did not stop on "
                             "SIGINT")
    if rc != 0:
        raise AssertionError(f"cluster_path: `cluster up` exited {rc}:\n"
                             f"{''.join(seen[-40:])}")


def _cluster_await_isr(bootstrap: str, want: int, where: str) -> float:
    """Poll the controller's ``status`` over CLUSTER_ADMIN until every
    shard's ISR holds ``want`` replicas on each partition it leads (the
    cluster's METADATA names the leaders)."""
    client = KafkaWireBroker(bootstrap, client_id="smoke-cluster-status")
    t0 = time.perf_counter()
    try:
        leader = {f"{t}:{p}": node for (t, p), node in
                  client.cluster_metadata()["leaders"].items()}
        deadline = time.monotonic() + 60
        while True:
            doc = client.cluster_admin("status")
            short = {(shard, tp): n
                     for shard, d in doc["shards"].items()
                     for tp, n in d["isr_size"].items()
                     if leader.get(tp) == int(shard) and n < want}
            if not short:
                return time.perf_counter() - t0
            if time.monotonic() > deadline:
                raise AssertionError(f"cluster_path ({where}): ISR below "
                                     f"{want} at {short}")
            time.sleep(0.05)
    finally:
        client.close()


def _cluster_batches(bootstrap: str, group: str, where: str):
    """The cardata job's 100 batches of 100 normal rows from offset 0 of
    every partition, read through a ``ClusterClient`` (RAW_FETCH routed to
    each owning shard, decoded by the columnar ring)."""
    cfg = cli_app.load_config([])[0]
    client = ClusterClient(bootstrap=bootstrap, client_id=f"smoke-{group}")
    try:
        consumer = StreamConsumer(
            client, [f"{STORE_TOPIC}:{p}:0" for p in range(CLUSTER_PARTS)],
            group=group)
        with _ring_read(f"cluster_path ({where})") as seen:
            sb = SensorBatches(consumer, batch_size=cardata.BATCH_SIZE,
                               take=cardata.TAKE_BATCHES,
                               only_normal=cfg.train.only_normal)
            seen["batchers"].append(sb)
            bs = list(next(sb.epochs(1)))
    finally:
        client.close()
    if len(bs) != cardata.TAKE_BATCHES or not all(b.mask.all() for b in bs):
        raise AssertionError(f"cluster_path ({where}): {len(bs)} batches, "
                             f"not {cardata.TAKE_BATCHES} full ones")
    return bs


def _cluster_fit(bs, where: str) -> dict:
    """``fit_compiled`` over ``bs`` for 20 epochs on the card from the
    trainer's seeded start: exactly one B1 launch, through rows."""
    trainer = Trainer(CAR_AUTOENCODER)
    trainer._ensure_state()
    before = _clone_state(trainer.state)
    launches = fused_train.fused_fit.launches
    rows = fused_train.fused_fit.launches_by_design["rows"]
    t0 = time.perf_counter()
    hist = trainer.fit_compiled(bs, epochs=FIT_EPOCHS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if fused_train.fused_fit.launches != launches + 1 or \
            fused_train.fused_fit.launches_by_design["rows"] != rows + 1:
        raise AssertionError(f"cluster_path ({where}): B1 launched "
                             f"{fused_train.fused_fit.launches - launches}"
                             f"x, not once through rows")
    return {"trainer": trainer, "before": before, "hist": hist,
            "seconds": seconds}


def _cluster_same_fit(a: dict, b: dict) -> None:
    """(e) The refit equals the first fit bit for bit: every epoch's loss
    and accuracy, params, mu, nu, step and count."""
    sa, sb = a["trainer"].state, b["trainer"].state
    if a["hist"]["loss"] != b["hist"]["loss"] or \
            a["hist"]["accuracy"] != b["hist"]["accuracy"]:
        raise AssertionError("cluster_path (e): the refit's losses differ")
    for tree, ta, tb in (("params", sa.params, sb.params),
                         ("mu", sa.opt_state.mu, sb.opt_state.mu),
                         ("nu", sa.opt_state.nu, sb.opt_state.nu)):
        for k in PARAM_NAMES:
            if not torch.equal(ta[k], tb[k]):
                raise AssertionError(f"cluster_path (e): the refit's "
                                     f"{tree}/{k} differs")
    if (sa.step, sa.opt_state.count) != (sb.step, sb.opt_state.count):
        raise AssertionError(f"cluster_path (e): step/count "
                             f"{sa.step}/{sa.opt_state.count} vs "
                             f"{sb.step}/{sb.opt_state.count}")


def _cluster_produce(client, entries, stats: dict, chunk: int,
                     deadline_s: float = 60.0):
    """acks=all produce, ``chunk`` records a call, each call one
    request a partition (the partition the client routes each key to),
    with the caller's redelivery: a NOT_LEADER bounce re-routes inside
    the client; any other ConnectionError (an ISR below min_isr, the
    quorum reached late or below min_isr, a retired leader's cut
    connection) redelivers that partition's request until the deadline
    (at least once: a request appended but unacked lands twice)."""
    deadline = time.monotonic() + deadline_s
    for i in range(0, len(entries), chunk):
        by_part: dict = collections.defaultdict(list)
        for e in entries[i:i + chunk]:
            by_part[client._partition_for(STORE_TOPIC, e[0])].append(e)
        for p, ents in sorted(by_part.items()):
            _cluster_deliver(client, p, ents, stats, deadline)


def _cluster_deliver(client, p: int, ents, stats: dict,
                     deadline: float) -> None:
    """One partition's request, redelivered until it is acked."""
    stats["requests"] = stats.get("requests", 0) + 1
    while True:
        try:
            client.produce_many(STORE_TOPIC, ents, partition=p, acks=-1,
                                timeout_ms=10_000)
            stats["acked"][stats["phase"]] += 1
            return
        except ConnectionError as e:
            stats["redeliveries"] += 1
            stats["errors"].add(type(e).__name__)
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _cluster_admin_cli(bootstrap: str, verb: str, shard: int) -> dict:
    """``python -m iotml_torch.cluster <verb> --shard N`` as a child
    against the running cluster: its report, which must end retired."""
    t0 = time.perf_counter()
    r = subprocess.run(CLUSTER_CMD + [verb, "--bootstrap", bootstrap,
                                      "--shard", str(shard)],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(Path(__file__).parent))
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"cluster_path (d): {verb} exited "
                             f"{r.returncode}:\n{r.stdout}\n{r.stderr}")
    doc = json.loads(r.stdout)
    if doc.get("state") != "retired":
        raise AssertionError(f"cluster_path (d): {verb} ended {doc}")
    doc["cli_seconds"] = seconds
    return doc


def _cluster_moves(bootstrap: str, tick) -> dict:
    """(d) Tick 2 produced at acks=all by one thread and tailed by a
    consumer on another while ``add-broker --shard 1`` and then
    ``drain-broker --shard 2`` run as children."""
    moves_done = threading.Event()
    # "phase" names the step each acked request lands in
    stats = {"redeliveries": 0, "errors": set(), "phase": "before",
             "acked": collections.Counter()}
    failed: list = []
    # the tail starts at tick 1's end on every partition
    probe = ClusterClient(bootstrap=bootstrap, client_id="smoke-cluster-end")
    try:
        start = [probe.end_offset(STORE_TOPIC, p)
                 for p in range(CLUSTER_PARTS)]
    finally:
        probe.close()
    produced = threading.Event()
    tail = {"records": 0, "max_stall_s": 0.0, "polls": 0}

    def produce():
        client = ClusterClient(bootstrap=bootstrap,
                               client_id="smoke-cluster-tick2")
        try:
            for i in range(0, len(tick), CLUSTER_CHUNK):
                _cluster_produce(client, tick[i:i + CLUSTER_CHUNK], stats,
                                 CLUSTER_CHUNK)
                if not moves_done.is_set():
                    time.sleep(CLUSTER_PACE_S)
        except BaseException as e:  # re-raised by the phase below
            failed.append(e)
        finally:
            produced.set()
            client.close()

    def consume():
        client = ClusterClient(bootstrap=bootstrap,
                               client_id="smoke-cluster-tail")
        try:
            consumer = StreamConsumer(
                client, [f"{STORE_TOPIC}:{p}:{start[p]}"
                         for p in range(CLUSTER_PARTS)],
                group="smoke-cluster-tail")
            last = time.perf_counter()
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                try:
                    batch = consumer.poll(4096)
                except ConnectionError:
                    batch = []
                tail["polls"] += 1
                now = time.perf_counter()
                if batch:
                    tail["records"] += len(batch)
                    tail["max_stall_s"] = max(tail["max_stall_s"],
                                              now - last)
                    last = now
                elif produced.is_set() and tail["records"] >= len(tick):
                    return
                else:
                    time.sleep(0.005)
            ends = [client.end_offset(STORE_TOPIC, p)
                    for p in range(CLUSTER_PARTS)]
            raise AssertionError(f"cluster_path (d): the tail consumer "
                                 f"read {tail['records']} of {len(tick)}: "
                                 f"positions {consumer.positions()}, "
                                 f"starts {start}, ends {ends}")
        except BaseException as e:
            failed.append(e)
        finally:
            client.close()

    threads = [threading.Thread(target=produce, daemon=True),
               threading.Thread(target=consume, daemon=True)]
    for t in threads:
        t.start()
    try:
        stats["phase"] = "add_broker"
        add = _cluster_admin_cli(bootstrap, "add-broker", 1)
        stats["phase"] = "drain_broker"
        drain = _cluster_admin_cli(bootstrap, "drain-broker", 2)
        stats["phase"] = "after"
    finally:
        moves_done.set()
        for t in threads:
            t.join(timeout=360)
    if failed:
        raise failed[0]
    if add["raw_mirrored"] <= 0:
        raise AssertionError(f"cluster_path (d): the new replica mirrored "
                             f"{add['raw_mirrored']} records over RAW_FETCH")
    if not stats["acked"]["add_broker"]:
        raise AssertionError(f"cluster_path (d): no tick-2 request was "
                             f"acked while add-broker ran: "
                             f"{dict(stats['acked'])}"
                             f", add-broker {add}, {stats['redeliveries']} "
                             f"redeliveries {sorted(stats['errors'])}")
    return {"add_broker": add, "drain_broker": drain,
            "requests_acked": dict(stats["acked"]),
            "redeliveries": stats["redeliveries"],
            "redelivery_errors": sorted(stats["errors"]),
            "tail_records": tail["records"],
            "consumer_max_stall_s": tail["max_stall_s"]}


def _count_rewinds(fleet) -> collections.Counter:
    """Each member's rewinds to its committed offsets, by the error that
    caused them (a refused write-back, a lost connection): the member's
    drive rewinds on any ConnectionError, and its next drain scores the
    records again."""
    rewinds: collections.Counter = collections.Counter()
    for m in fleet.members:
        real_drain = m.payload.score_available

        def drain(*a, real_drain=real_drain, **kw):
            try:
                return real_drain(*a, **kw)
            except ConnectionError as e:
                rewinds[type(e).__name__] += 1
                raise

        m.payload.score_available = drain
    return rewinds


@contextlib.contextmanager
def _fleet_identities(fleet):
    """Each member's decoded records in order, as (partition, offset): the
    member's fetch_raw calls name the partition, and the frame decoder's
    calls after each (on the member's thread) the offsets it turned into
    rows."""
    owner = {id(m.client): i for i, m in enumerate(fleet.members)}
    seq = [[] for _ in fleet.members]
    last = threading.local()
    real_fetch = ClusterClient.fetch_raw
    real_decode = native.FrameDecoder.decode_into

    def fetch_raw(self, topic, partition, offset, *a, **kw):
        last.at = (owner.get(id(self)), partition)
        return real_fetch(self, topic, partition, offset, *a, **kw)

    def decode_into(self, data, offset, *a, **kw):
        got, next_off, flags, skipped = real_decode(self, data, offset,
                                                    *a, **kw)
        member, part = getattr(last, "at", (None, None))
        if got:
            if member is None or got != next_off - offset:
                raise AssertionError(f"cluster_path (f): {got} rows "
                                     f"decoded at {offset}..{next_off} "
                                     f"outside a member's fetch")
            seq[member].extend((part, o) for o in range(offset, next_off))
        return got, next_off, flags, skipped

    ClusterClient.fetch_raw = fetch_raw
    native.FrameDecoder.decode_into = decode_into
    try:
        yield seq
    finally:
        ClusterClient.fetch_raw = real_fetch
        native.FrameDecoder.decode_into = real_decode


def _cluster_acked_present(bootstrap: str, ticks) -> dict:
    """(d) After the moves every acked record of both ticks is in the
    log, in the partition its key routes to; the redeliveries' extra
    copies are counted, and no record came from anywhere else."""
    client = ClusterClient(bootstrap=bootstrap, client_id="smoke-cluster-rb")
    try:
        want: collections.Counter = collections.Counter()
        for tick in ticks:
            want.update((client._partition_for(STORE_TOPIC, k), k, v)
                        for k, v, _ in tick)
        got: collections.Counter = collections.Counter()
        for p in range(CLUSTER_PARTS):
            off, end = 0, client.end_offset(STORE_TOPIC, p)
            while off < end:
                raw = client.fetch_raw(STORE_TOPIC, p, off,
                                       max_bytes=4 << 20)
                at = off
                for o, k, v, _, _ in iter_frame_entries(
                        b"" if raw is None else raw.data):
                    if o >= at:
                        got[(p, k, v)] += 1
                        at = o + 1
                if at == off:
                    raise AssertionError(f"cluster_path (d): partition {p} "
                                         f"read back stopped at {off}/{end}")
                off = at
    finally:
        client.close()
    missing, extra = want - got, got - want
    phantom = set(extra) - set(want)
    if missing or phantom:
        raise AssertionError(f"cluster_path (d): {sum(missing.values())} "
                             f"acked records missing after the moves, "
                             f"{len(phantom)} records from nowhere")
    return {"records": sum(want.values()), "log_records": sum(got.values()),
            "duplicates": sum(extra.values())}


def _cluster_log_rows(bootstrap: str) -> dict:
    """Every partition's rows in offset order, decoded on the host: the
    CPU recompute's inputs."""
    client = ClusterClient(bootstrap=bootstrap, client_id="smoke-cluster-x")
    try:
        out = {}
        for p in range(CLUSTER_PARTS):
            bs = SensorBatches(StreamConsumer(client, [f"{STORE_TOPIC}:{p}:0"],
                                              group="smoke-cluster-x"),
                               batch_size=100, only_normal=False)
            out[p] = np.concatenate([b.x[:b.n_valid] for b in bs])
        return out
    finally:
        client.close()


def _cluster_fleet(bootstrap: str, params) -> dict:
    """(f) A 3-member ``ScorerFleet`` on the card, one thread a member as
    a deployment runs it (``start``), at the scorer's own flush (an
    acks=all write-back of up to ``max_super_batches`` batches), scores
    every record of both ticks: each (partition, offset) exactly once,
    and each member's first payloads against a CPU recompute from the
    same params."""
    probe = ClusterClient(bootstrap=bootstrap, client_id="smoke-cluster-end")
    try:
        ends = [probe.end_offset(STORE_TOPIC, p) for p in range(CLUSTER_PARTS)]
    finally:
        probe.close()
    expected = {(p, o) for p in range(CLUSTER_PARTS) for o in range(ends[p])}
    fleet = ScorerFleet(
        lambda: ClusterClient(bootstrap=bootstrap,
                              client_id="smoke-cluster-fleet"),
        CAR_AUTOENCODER, params, n_members=CLUSTER_FLEET,
        in_topic=STORE_TOPIC, out_topic=CLUSTER_TOPICS[1],
        group="smoke-cluster-fleet")
    rewinds = _count_rewinds(fleet)
    with _fleet_identities(fleet) as seq:
        try:
            t0 = time.perf_counter()
            fleet.start()
            deadline = time.monotonic() + 300
            while fleet.scored() < len(expected):
                if time.monotonic() > deadline:
                    raise AssertionError(f"cluster_path (f): the fleet "
                                         f"scored {fleet.scored()} of "
                                         f"{len(expected)}")
                time.sleep(0.01)
            seconds = time.perf_counter() - t0
        finally:
            fleet.stop()
    torch.cuda.synchronize()
    rounds = sum(m.rounds for m in fleet.members)
    if rewinds:
        raise AssertionError(f"cluster_path (f): {sum(rewinds.values())} "
                             f"write-backs or fetches failed and rewound "
                             f"({dict(rewinds)})")
    flat = [ident for member in seq for ident in member]
    dupes = len(flat) - len(set(flat))
    missing, extra = expected - set(flat), set(flat) - expected
    per_member = [m.payload.scored for m in fleet.members]
    if dupes or missing or extra or fleet.scored() != len(expected) or \
            per_member != [len(s) for s in seq] or not all(per_member):
        raise AssertionError(f"cluster_path (f): {len(missing)} records "
                             f"never scored, {dupes} scored twice, "
                             f"{len(extra)} phantom; members "
                             f"{per_member} vs decoded "
                             f"{[len(s) for s in seq]}")
    # the first payloads of each member against the CPU forward of the
    # same records from the log
    xs = _cluster_log_rows(bootstrap)
    cpu = {k: v.detach().cpu() for k, v in params.items()}
    client = ClusterClient(bootstrap=bootstrap, client_id="smoke-cluster-out")
    n = -(-CLUSTER_CHECKED_PAYLOADS // CLUSTER_FLEET)
    err_first = err_all = 0.0
    try:
        for m in range(CLUSTER_FLEET):
            msgs = []
            while len(msgs) < n:
                got = client.fetch(CLUSTER_TOPICS[1], m, len(msgs), n)
                if not got:
                    break
                msgs.extend(got)
            # a threshold-less scorer's payload is the output row alone
            rows = np.array([np.array(g.value.decode().strip("[]").split(),
                                      np.float64) for g in msgs[:n]])
            x = torch.from_numpy(np.stack([xs[p][o] for p, o in seq[m][:n]]))
            with torch.no_grad():
                want = torch.func.functional_call(
                    CAR_AUTOENCODER.build("cpu"), cpu, (x,)).numpy()
            if rows.shape != want.shape or not np.isfinite(rows).all() or \
                    not np.allclose(rows[:100], want[:100], **CLI_TOL_FIRST) \
                    or not np.allclose(rows, want, **CLI_TOL_ALL):
                raise AssertionError(
                    f"cluster_path (f): member {m}'s payloads {rows.shape} "
                    f"disagree with a CPU recompute (max "
                    f"{np.abs(rows - want).max() if rows.shape == want.shape else 'n/a'})")
            err_first = max(err_first,
                            float(np.abs(rows[:100] - want[:100]).max()))
            err_all = max(err_all, float(np.abs(rows - want).max()))
    finally:
        client.close()
    return {"records": len(expected), "scored_by_member": per_member,
            "lost": 0, "double_scored": 0, "rounds": rounds,
            "super_batches": fleet.members[0].payload.max_super_batches,
            "seconds": seconds, "rows_per_s": len(expected) / seconds,
            "payloads_checked": n * CLUSTER_FLEET,
            "max_abs_err_first_100": err_first,
            "max_abs_err_checked": err_all}


def _cluster_drills() -> dict:
    """(g) ``python -m iotml_torch.cluster drill --seed 7`` and ``python -m
    iotml_torch.replication drill --name reassign``, in-process."""
    from iotml_torch.cluster.__main__ import main as cluster_main
    from iotml_torch.replication.__main__ import main as repl_main

    out = {}
    for name, main, argv in (
            ("rebalance_under_chaos", cluster_main, ["drill", "--seed", "7"]),
            ("reassign", repl_main, ["drill", "--name", "reassign"])):
        so, se = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = main(argv)
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cluster_path (g): {name} drill exited "
                                 f"{rc}:\n{se.getvalue()}")
        doc = json.loads(so.getvalue())
        out[name] = {"ok": doc["ok"], "seconds": seconds,
                     "published": doc["published"], "scored": doc["scored"],
                     "slos": doc.get("slos"),
                     "invariants": [i["name"] for i in doc["invariants"]]}
    return out


def phase_cluster_path(card: str, root: str) -> dict:
    """The partitioned cluster under the main path: (a) ``cluster up``,
    (b) one tick at acks=all, (c) the fit, (d) the moves under load, (e)
    the refit, (f) the scorer fleet, (g) the drills."""
    reset_launches()
    reset_fit_launches()
    t_phase = time.perf_counter()
    store_root = str(Path(root) / "cluster")
    counts: dict = {}
    t0 = time.perf_counter()
    proc, bootstrap, seen = _cluster_up(store_root)
    up_s = time.perf_counter() - t0
    try:
        isr_s = _cluster_await_isr(bootstrap, CLUSTER_RF, "a")
        # (b) one tick of the fleet at acks=all through the routed client
        tick1, tick2 = list(_store_ticks(2))
        client = ClusterClient(bootstrap=bootstrap,
                               client_id="smoke-cluster-tick1")
        tick1_stats = {"redeliveries": 0, "errors": set(), "phase": "tick",
                       "acked": collections.Counter()}
        try:
            t0 = time.perf_counter()
            _cluster_produce(client, tick1, tick1_stats, CLUSTER_TICK_CHUNK)
            tick_s = time.perf_counter() - t0
        finally:
            client.close()
        acks_all_rate = len(tick1) / tick_s

        # (c) the cardata fit over the routed client
        bs = _cluster_batches(bootstrap, "smoke-cluster-fit", "c")
        counts["fit"] = 1
        fit = _cluster_fit(bs, "c")
        xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
        masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
        rows = np.concatenate([b.x for b in bs])
        bound = order_noise_bound(fit["before"], [rows], masks)
        err, drift = _store_fit_check(fit["trainer"], fit["before"],
                                      fit["hist"], xs, masks, bound,
                                      tag="cluster_path")

        # (d) add-broker and drain-broker while tick 2 is produced
        moves = _cluster_moves(bootstrap, tick2)
        reform_s = _cluster_await_isr(bootstrap, CLUSTER_MIN_ISR, "d")
        t0 = time.perf_counter()
        read_back = _cluster_acked_present(bootstrap, (tick1, tick2))
        read_back["seconds"] = time.perf_counter() - t0

        # (e) the refit from offset 0 after the moves
        bs2 = _cluster_batches(bootstrap, "smoke-cluster-refit", "e")
        _same_batches(bs, bs2, "cluster_path (e) refit")
        counts["refit"] = 1
        refit = _cluster_fit(bs2, "e")
        _cluster_same_fit(fit, refit)

        # (f) the scorer fleet over both ticks
        fleet = _cluster_fleet(bootstrap, fit["trainer"].state.params)
    finally:
        _cluster_stop(proc, seen)

    # (g) the drills
    drills = _cluster_drills()
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if launches != sum(counts.values()) or by_design["rows"] != launches:
        raise AssertionError(f"cluster_path launched B1 {launches}x "
                             f"({by_design}), sub-phases say {counts}")
    attention = {k: v for k, v in path_launches().items() if k != "fused_fit"}
    if any(attention.values()):
        raise AssertionError(f"cluster_path launched {attention}")
    shutil.rmtree(store_root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    add, drain = moves["add_broker"], moves["drain_broker"]
    emit({"phase": "cluster_path", "card": card, "cars": STORE_CARS,
          "brokers": CLUSTER_BROKERS, "partitions": CLUSTER_PARTS,
          "replication_factor": CLUSTER_RF, "min_isr": CLUSTER_MIN_ISR,
          "bootstrap_s": up_s, "isr_form_s": isr_s,
          "acks_all_records_per_s": acks_all_rate, "tick_s": tick_s,
          "tick_redeliveries": tick1_stats["redeliveries"],
          "tick_redelivery_errors": sorted(tick1_stats["errors"]),
          "fit": {"seconds": fit["seconds"],
                  "refit_seconds": refit["seconds"],
                  "loss": fit["hist"]["loss"][-1],
                  "refit_bit_equal": True, "max_abs_err_vs_plain": err,
                  "params_drift": drift, "bound": public_bound(bound)},
          "add_broker": {k: add.get(k) for k in (
              "state", "epoch", "catch_up_s", "move_s", "raw_mirrored",
              "records_mirrored", "cli_seconds")},
          "drain_broker": {k: drain.get(k) for k in (
              "state", "epoch", "move_s", "cli_seconds")},
          "moves_load": {k: moves[k] for k in (
              "requests_acked", "redeliveries", "redelivery_errors",
              "tail_records")},
          "read_back": read_back,
          "consumer_max_stall_s": moves["consumer_max_stall_s"],
          "isr_reform_s": reform_s, "fleet": fleet, "drills": drills,
          "phase_seconds": phase_s, "kernel_launches": launches,
          "kernel_launches_by_design": by_design,
          "kernel_launches_by_subphase": counts})
    return {"launches": launches, "launches_by_design": by_design,
            "by_subphase": counts, "max_abs_err": err}


# ------------------------------------------------------------- chaos_path
#: the scenarios at the JAX package's CI sizes (chaos.yml, mlops.yml and
#: online.yml run 2,000 records, deploy/smoke.sh 500), each through the
#: chaos CLI in this process
CHAOS_SCENARIOS = (
    ("mqtt-flap", 2000), ("slow-bridge", 2000), ("dup-storm", 2000),
    ("partition-blackout", 2000), ("scorer-crash-resume", 2000),
    ("loss-bug-fixture", 2000), ("leader-kill-mid-drain", 2000),
    ("trainer-crash-mid-checkpoint", 2000),
    ("rollout-regression-rollback", 2000), ("drift-storm", 2000),
    ("broker-crash-recover", 500), ("tier-upload-crash", 500),
    ("double-fault", 500))
#: alert-burn at tsdb.yml's size, in a process of its own (its canaries'
#: latency SLO pages on a loaded host: see telemetry_path)
CHAOS_CHILD = ("alert-burn", 600)
#: the scenarios that must FAIL: the checker checked
CHAOS_MUST_FAIL = ("loss-bug-fixture",)
#: held to the port's CPU run of the same scenario instead of a pass: at
#: seed 7 both packages end drift-storm still adapting
#: (``adaptation_converged`` fails on the CPU in each)
CHAOS_CPU_HELD = ("drift-storm",)
#: the scenarios that fit the autoencoder (B1): the trainer's rounds and
#: the rollback's baseline (drift-storm's learner adapts by a learning-rate
#: boost at seed 7 and refits nothing)
CHAOS_FITS = ("trainer-crash-mid-checkpoint", "rollout-regression-rollback")
#: the card's production scorer against a CPU recompute, parsed payloads:
#: the baseline's rows at the scorer's payload bound; the candidate's (its
#: weights + N(0, 1)) at the smoke's all-rows bound, CLI_TOL_ALL: its
#: layers sum terms of ~10 that cancel to small outputs, so two float32
#: orders of those sums differ by a few ulps of ~10, not of the output
#: (2.67e-6 measured on the card)
CHAOS_PAYLOAD_TOL = {"baseline": dict(rtol=0.0, atol=1e-6),
                     "candidate": CLI_TOL_ALL}


def _chaos_cli(argv, device=None) -> tuple:
    """``python -m iotml_torch.chaos`` in this process: (exit status,
    the --json report, seconds)."""
    from iotml_torch.chaos.__main__ import main as chaos_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = chaos_main(argv, device=device)
    if device is None:
        torch.cuda.synchronize()
    return rc, json.loads(out.getvalue()), time.perf_counter() - t0


@contextlib.contextmanager
def _first_card_fit(record: dict):
    """Record the first ``Trainer.fit_compiled`` on the card while active:
    its batches, the state it starts from and ends at, its history and
    its B1 launches."""
    real = Trainer.fit_compiled

    def fit(self, batches, epochs: int = 1, fused: str = "auto"):
        if record or self.device.type != "cuda":
            return real(self, batches, epochs, fused)
        bs = list(next(batches.epochs(1)))  # the round's one poll
        self._ensure_state()
        before = _clone_state(self.state)
        launched = fused_train.fused_fit.launches
        history = real(self, bs, epochs, fused)
        record.update(batches=bs, epochs=epochs, before=before,
                      history=history, after=_clone_state(self.state),
                      launches=fused_train.fused_fit.launches - launched)
        return history

    Trainer.fit_compiled = fit
    try:
        yield record
    finally:
        Trainer.fit_compiled = real


def _chaos_round_check(r: dict) -> float:
    """(d) the recorded B1 round against the plain version on its rows."""
    if r.get("launches") != 1:
        raise AssertionError(f"chaos_path (d): the trainer-crash round "
                             f"launched B1 {r.get('launches')}x")
    xs = torch.from_numpy(np.stack([b.x for b in r["batches"]])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in r["batches"]])).cuda()
    p_state, p_loss, p_acc = fused_train.fused_fit_reference(
        r["before"], xs, masks, r["epochs"])
    return check_fit("chaos_path (d) trainer-crash round",
                     (r["after"], torch.tensor(r["history"]["loss"]),
                      torch.tensor(r["history"]["accuracy"])),
                     (p_state, p_loss.cpu(), p_acc.cpu()),
                     r["before"].step + len(r["batches"]) * r["epochs"])


def _chaos_scenarios() -> dict:
    """(a) every ported scenario through the chaos CLI, each with the
    launch counts set to 0 just before and read just after; alert-burn
    as a child process."""
    out, fit_record = {}, {}
    for name, records in CHAOS_SCENARIOS:
        argv = ["run", "--scenario", name, "--seed", "7", "--records",
                str(records), "--json"]
        reset_launches()
        reset_fit_launches()
        if name == "trainer-crash-mid-checkpoint":
            with _first_card_fit(fit_record):
                rc, doc, seconds = _chaos_cli(argv)
        else:
            rc, doc, seconds = _chaos_cli(argv)
        launches = fused_train.fused_fit.launches
        by_design = dict(fused_train.fused_fit.launches_by_design)
        attention = {k: v for k, v in path_launches().items()
                     if k != "fused_fit"}
        failed = [i["name"] for i in doc["invariants"] if not i["ok"]]
        want_rc = 1 if name in CHAOS_MUST_FAIL else 0
        entry = {"records": records, "seconds": seconds, "rc": rc,
                 "published": doc["published"], "scored": doc["scored"],
                 "rewinds": doc["rewinds"],
                 "dropped_accounted": doc["dropped_accounted"],
                 "injected": doc["injected"], "failed": failed,
                 "verdicts": {i["name"]: i["ok"]
                              for i in doc["invariants"]},
                 "b1_launches": launches,
                 "b1_launches_by_design": by_design}
        if name in CHAOS_CPU_HELD:
            cpu_rc, cpu, cpu_s = _chaos_cli(argv, device="cpu")
            cpu_failed = [i["name"] for i in cpu["invariants"]
                          if not i["ok"]]
            same = {k: cpu[k] for k in ("published", "scored", "rewinds",
                                        "dropped_accounted", "injected")}
            if rc != cpu_rc or failed != cpu_failed or same != {
                    k: doc[k] for k in same} or [
                    i["name"] for i in cpu["invariants"]] != list(
                    entry["verdicts"]):
                raise AssertionError(
                    f"chaos_path (a): {name} on the card (rc {rc}, failed "
                    f"{failed}) differs from the port's CPU run (rc "
                    f"{cpu_rc}, failed {cpu_failed})")
            entry["cpu_failed"], entry["cpu_seconds"] = cpu_failed, cpu_s
            want_rc = cpu_rc
        elif name in CHAOS_MUST_FAIL:
            if "scored_or_accounted" not in failed:
                raise AssertionError(f"chaos_path (a): {name} failed "
                                     f"{failed}, not scored_or_accounted")
        if rc != want_rc or (want_rc == 0 and failed):
            raise AssertionError(
                f"chaos_path (a): {name} exited {rc}, want {want_rc}:\n"
                + "\n".join(f"{'PASS' if i['ok'] else 'FAIL'}  "
                            f"{i['name']}: {i['detail']}"
                            for i in doc["invariants"]))
        if any(attention.values()):
            raise AssertionError(f"chaos_path (a): {name} launched "
                                 f"{attention}")
        if (launches > 0) != (name in CHAOS_FITS) or \
                sum(by_design.values()) != launches:
            raise AssertionError(f"chaos_path (a): {name} launched B1 "
                                 f"{launches}x ({by_design})")
        out[name] = entry
    name, records = CHAOS_CHILD
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "iotml_torch.chaos", "run", "--scenario",
         name, "--seed", "7", "--records", str(records), "--json"],
        capture_output=True, text=True, timeout=300,
        cwd=str(Path(__file__).parent))
    seconds = time.perf_counter() - t0
    try:
        doc = json.loads(proc.stdout[proc.stdout.index("{"):])
    except ValueError:
        raise AssertionError(f"chaos_path (a): {name} exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-4000:]}")
    if proc.returncode != 0 or not doc["ok"]:
        raise AssertionError(
            f"chaos_path (a): {name} exited {proc.returncode}:\n"
            + "\n".join(f"{'PASS' if i['ok'] else 'FAIL'}  {i['name']}: "
                        f"{i['detail']}" for i in doc["invariants"]))
    out[name] = {"records": records, "seconds": seconds, "rc": 0,
                 "process": "child", "published": doc["published"],
                 "scored": doc["scored"], "injected": doc["injected"],
                 "failed": [],
                 "verdicts": {i["name"]: i["ok"]
                              for i in doc["invariants"]}}
    return {"scenarios": out, "fit_record": fit_record}


def _chaos_drills() -> dict:
    """(b) ``python -m iotml_torch.mlops drill --all --seed 7`` in this
    process; the rollback's production scorer is recorded (its polled
    rows in order, each swap with the rows scored before it) for (d)."""
    from iotml_torch.mlops import __main__ as mlops_cli
    from iotml_torch.mlops import drill as mlops_drill

    seen: dict = {}
    real_make = mlops_drill._make_scorer

    def make(broker, consumer, params, threshold=None, device=None):
        scorer = real_make(broker, consumer, params, threshold=threshold,
                           device=device)
        if threshold is None:
            return scorer  # the rollout drill's
        polled, swaps, weights = [], [], {}
        poll, set_params = consumer.poll, scorer.set_params

        def recording_poll(max_messages=1024):
            batch = poll(max_messages)
            polled.extend(batch)
            return batch

        def recording_set_params(p, version=None):
            swaps.append((version, scorer.scored))
            weights[version] = {k: v.detach().cpu().clone()
                                for k, v in p.items()}
            set_params(p, version=version)

        consumer.poll = recording_poll
        scorer.set_params = recording_set_params
        seen.update(scorer=scorer, broker=broker, polled=polled,
                    swaps=swaps, weights=weights)
        return scorer

    reset_launches()
    reset_fit_launches()
    mlops_drill._make_scorer = make
    out = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mlops_cli.main(["drill", "--all", "--seed", "7", "--json"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        mlops_drill._make_scorer = real_make
    text, docs, at = out.getvalue().strip(), [], 0
    while at < len(text):
        doc, at = json.JSONDecoder().raw_decode(text, at)
        docs.append(doc)
        at = len(text) - len(text[at:].lstrip())
    if rc != 0 or not all(d["ok"] for d in docs):
        raise AssertionError(
            f"chaos_path (b): mlops drill --all exited {rc}:\n" + "\n".join(
                f"{d['drill']} {'PASS' if i['ok'] else 'FAIL'}  "
                f"{i['name']}: {i['detail']}"
                for d in docs for i in d["invariants"]))
    by = {d["drill"]: d for d in docs}
    launches = fused_train.fused_fit.launches
    if launches != 1:  # the rollback's baseline round
        raise AssertionError(f"chaos_path (b): the drills launched B1 "
                             f"{launches}x, not once")
    swap_s = by["rollout"]["slos"]["worst_swap_latency_s"]
    rollback_s = by["rollback"]["slos"]["time_to_rollback_s"]
    return {"seconds": seconds, "launches": launches,
            "launches_by_design": dict(
                fused_train.fused_fit.launches_by_design),
            "swap_s": swap_s, "slo_swap_s": 5.0,
            "rollback_s": rollback_s, "slo_rollback_s": 60.0,
            "healed_s": by["rollback"]["slos"][
                "time_to_production_healed_s"],
            "published": {k: d["published"] for k, d in by.items()},
            "restarts": {k: d["restarts"] for k, d in by.items()},
            "seen": seen}


def _chaos_payloads(seen: dict) -> dict:
    """(d) the rollback drill's production scorer against a CPU
    recompute: every payload row within CHAOS_PAYLOAD_TOL of the
    baseline's or the candidate's forward on its input row, in segments
    baseline, candidate, baseline as the swaps ran."""
    scorer, broker, polled = seen["scorer"], seen["broker"], seen["polled"]
    n = broker.end_offset("model-predictions", 0)
    if len(polled) != n or scorer.scored != n:
        raise AssertionError(f"chaos_path (d): {len(polled)} rows polled, "
                             f"{scorer.scored} scored, {n} payloads")
    rows_in = Broker()
    rows_in.create_topic("rows", partitions=1)
    for m in polled:
        rows_in.produce("rows", m.value, key=m.key, partition=0,
                        timestamp_ms=m.timestamp_ms)
    baseline_v = scorer.model_version
    candidate_v = next(v for v in seen["weights"] if v != baseline_v)
    got = _payload_parts([m.value.decode() for m in broker.fetch(
        "model-predictions", 0, 0, n)])[0]
    wants = {}
    for tag, v in (("baseline", baseline_v), ("candidate", candidate_v)):
        wants[tag], _x = _recompute(rows_in, seen["weights"][v],
                                    topic="rows")
    errs = {tag: np.abs(got - want).max(axis=1)
            for tag, want in wants.items()}
    within = {tag: (np.abs(got - want) <= CHAOS_PAYLOAD_TOL[tag]["atol"]
                    + CHAOS_PAYLOAD_TOL[tag]["rtol"] * np.abs(want)
                    ).all(axis=1)
              for tag, want in wants.items()}
    labels = []
    for i in range(n):
        ok = [t for t in ("baseline", "candidate") if within[t][i]]
        if not ok:
            raise AssertionError(
                f"chaos_path (d): payload {i} is neither version's "
                f"forward (max abs err baseline {errs['baseline'][i]}, "
                f"candidate {errs['candidate'][i]})")
        labels.append(ok[0])
    segments = [labels[0]] + [b for a, b in zip(labels, labels[1:])
                              if a != b]
    if segments[0] != "baseline" or segments[-1] != "baseline" or \
            len(segments) > 3:
        raise AssertionError(f"chaos_path (d): version segments "
                             f"{segments} (swaps {seen['swaps']})")
    return {"payloads": n, "baseline_version": baseline_v,
            "candidate_version": candidate_v,
            "rows_by_version": {t: labels.count(t) for t in wants},
            "segments": segments,
            "max_abs_err": {t: float(errs[t][np.array(labels) == t].max())
                            for t in set(labels)},
            "tolerance": CHAOS_PAYLOAD_TOL}


def _chaos_supervised(root: str) -> dict:
    """(c) ``Platform.supervised(poll_interval_s=0.02)`` on the card: the
    KSQL pump thread killed and respawned; the attached checkpoint writer
    crashed once at ``ckpt.write`` and restarted, the snapshot still
    queued published with the trainer's params bit for bit; then
    ``python -m iotml_torch.cli.up --supervise`` as a child printing its
    unit count."""
    reg_dir = str(Path(root) / "chaos-registry")
    plat = Platform(partitions=10, registry_dir=reg_dir, cc_port=0).start()
    sup = None
    try:
        writer = plat.attach_checkpointer(
            AsyncCheckpointer(plat.model_registry, queue_depth=2))
        sup = plat.supervised(poll_interval_s=0.02)
        units = [u.name for u in sup.units()]
        trainers = []
        for seed, cursor in ((1, 5), (2, 9)):
            tr = Trainer(CAR_AUTOENCODER, seed=seed)  # the card
            tr._ensure_state()
            trainers.append(tr)
            writer.snapshot(tr.state, [(STORE_TOPIC, 0, cursor)])
        obs_faults.arm(obs_faults.ChaosEngine([obs_faults.FaultEvent(
            1, "ckpt.write", "error", (("exc", "RuntimeError"),))]))
        t0 = time.perf_counter()
        sup.start()
        deadline = time.monotonic() + 30
        while plat.model_registry.versions() != [1]:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"chaos_path (c): the writer published "
                    f"{plat.model_registry.versions()} after its crash "
                    f"({sup.snapshot()})")
            time.sleep(0.005)
        writer_s = time.perf_counter() - t0
        obs_faults.disarm()
        m = plat.model_registry.manifest(1)
        got = params_from_h5_bytes(
            plat.model_registry.load_bytes(1, "model.h5"))
        if sup.unit("ckpt-writer").restarts != 1 or \
                [tuple(o) for o in m.offsets] != [(STORE_TOPIC, 0, 9)] or \
                not all(torch.equal(got[k], v.cpu()) for k, v in
                        trainers[1].state.params.items()):
            raise AssertionError(
                f"chaos_path (c): writer restarts "
                f"{sup.unit('ckpt-writer').restarts}, offsets {m.offsets}, "
                f"params equal to the trainer's: "
                f"{[torch.equal(got[k], v.cpu()) for k, v in trainers[1].state.params.items()]}")
        deadline = time.monotonic() + 10
        while sup.unit("ksql-tasks").state != "running":
            if time.monotonic() > deadline:
                raise AssertionError("chaos_path (c): ksql-tasks never ran")
            time.sleep(0.005)
        # kill the continuous-query pump thread as a bug would: its stop
        # flag set, the thread exits, nobody restarts it by hand
        t0 = time.perf_counter()
        plat.ksql._stop.set()
        deadline = time.monotonic() + 10
        while sup.unit("ksql-tasks").restarts < 1:
            if time.monotonic() > deadline:
                raise AssertionError("chaos_path (c): the dead KSQL pump "
                                     "was never restarted")
            time.sleep(0.001)
        detected_s = time.perf_counter() - t0
        plat.ksql._stop.clear()
        while not (plat.ksql._pump_thread.is_alive()
                   and sup.unit("ksql-tasks").state == "running"):
            if time.monotonic() > deadline:
                raise AssertionError("chaos_path (c): the KSQL pump never "
                                     "ran again")
            time.sleep(0.001)
        pump_restart_s = time.perf_counter() - t0
    finally:
        obs_faults.disarm()
        if sup is not None:
            sup.stop()
        plat.stop()
    child = _chaos_up_child()
    return {"units": units, "pump_restart_detected_s": detected_s,
            "pump_restart_s": pump_restart_s,
            "writer_crash_to_publish_s": writer_s,
            "writer_restarts": 1, "snapshot_bit_equal": True,
            "cli": child}


def _chaos_up_child() -> dict:
    """``python -m iotml_torch.cli.up --supervise`` as a child: its
    ``supervisor N units`` line, then Ctrl-C."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "iotml_torch.cli.up", "--supervise",
         "--metrics-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(Path(__file__).parent))
    seen, units = [], None
    try:
        for line in proc.stdout:
            seen.append(line)
            if line.strip().startswith("supervisor"):
                units = int(line.split()[1])
            if line.startswith("Ctrl-C to stop."):
                break
        up_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=60)
        seen.append(rest)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("chaos_path (c): `cli.up --supervise` did not "
                             "stop on SIGINT")
    # kafka-wire, mqtt-front, ksql-tasks, connect-driver, schema-registry,
    # control-center: the command line serves Connect and the control
    # center on port 0 by default
    if proc.returncode != 0 or units != 6 or "stopped." not in rest:
        raise AssertionError(f"chaos_path (c): `cli.up --supervise` exited "
                             f"{proc.returncode}, units {units}:\n"
                             f"{''.join(seen)[-3000:]}")
    return {"units": units, "up_s": up_s, "rc": 0}


def phase_chaos_path(card: str, root: str) -> dict:
    """The chaos runner, the mlops drills and the supervised platform on
    the card: (a) the scenarios, (b) the drills, (c) supervision, (d) the
    numerics of a trainer-crash B1 round and the rollback's production
    scorer."""
    t_phase = time.perf_counter()
    a = _chaos_scenarios()
    fit_err = _chaos_round_check(a["fit_record"])
    b = _chaos_drills()
    payloads = _chaos_payloads(b.pop("seen"))
    c = _chaos_supervised(root)
    scen = a["scenarios"]
    by_scenario = {n: s["b1_launches"] for n, s in scen.items()
                   if "b1_launches" in s}
    by_scenario["mlops_drill_rollback"] = b["launches"]
    launches = sum(by_scenario.values())
    by_design = {d: sum(s.get("b1_launches_by_design", {}).get(d, 0)
                        for s in scen.values())
                 + b["launches_by_design"][d] for d in fused_train.DESIGNS}
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "chaos_path", "card": card,
          "scenarios": {n: {k: s[k] for k in (
              "records", "seconds", "rc", "published", "scored",
              "injected", "verdicts") if k in s} | (
              {"cpu_failed": s["cpu_failed"]} if "cpu_failed" in s else {})
              for n, s in scen.items()},
          "drills": {k: b[k] for k in (
              "seconds", "swap_s", "slo_swap_s", "rollback_s",
              "slo_rollback_s", "healed_s", "published", "restarts")},
          "supervised": c,
          "numerics": {"trainer_crash_round_max_abs_err": fit_err,
                       "rollback_payloads": payloads},
          "phase_seconds": phase_s, "kernel_launches": launches,
          "kernel_launches_by_design": by_design,
          "kernel_launches_by_scenario": by_scenario})
    return {"launches": launches, "launches_by_design": by_design,
            "by_scenario": by_scenario, "max_abs_err": fit_err}


# -------------------------------------------------------------- twin_path
#: the reference's fleet (README.md: 100,000 cars) for two ticks into the
#: sensor topic's 10 partitions (01_installConfluentPlatform.sh:180-183)
TWIN_CARS = 100_000
TWIN_TICKS = 2
TWIN_PARTITIONS = 10
#: cars queried over GET /twin/<car>, every TWIN_CARS // TWIN_QUERIES-th
TWIN_QUERIES = 1_000
#: the joined fit: the main path's slice (100 batches of 100 rows, 20
#: epochs) with each live row joined to its car's twin features
TWIN_FIT_BATCHES = 100
TWIN_FIT_EPOCHS = 20
#: deploy/smoke.sh's sizes for the drill and the compaction scenario
TWIN_DRILL_ARGV = ["drill", "--seed", "7", "--records", "1500"]
TWIN_CHAOS_ARGV = ["run", "--scenario", "compaction-under-crash", "--seed",
                   "7", "--records", "500", "--json"]
TWIN_DRILL_INVARIANTS = ("rebuild_equals_snapshot", "resume_no_refold",
                         "compaction_reclaimed", "retired_stay_retired",
                         "rest_serves_twin")


def _twin_drill_cli() -> dict:
    """(a) ``python -m iotml_torch.twin drill`` through its ``main`` in
    this process: exit 0 and all five invariants printed as PASS."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = twin_cli(TWIN_DRILL_ARGV)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    passed = [line.split()[1].rstrip(":") for line in lines[1:]
              if line.strip().startswith("PASS")]
    if rc != 0 or tuple(passed) != TWIN_DRILL_INVARIANTS:
        raise AssertionError(f"twin_path (a): the twin drill exited {rc}:\n"
                             + out.getvalue())
    return {"rc": rc, "seconds": seconds, "summary": lines[0],
            "invariants_passed": passed}


def _twin_chaos() -> dict:
    """(b) the compaction-under-crash scenario through the chaos CLI."""
    rc, doc, seconds = _chaos_cli(TWIN_CHAOS_ARGV)
    failed = [i["name"] for i in doc["invariants"] if not i["ok"]]
    if rc != 0 or failed or not doc["ok"]:
        raise AssertionError(
            f"twin_path (b): compaction-under-crash exited {rc}:\n"
            + "\n".join(f"{'PASS' if i['ok'] else 'FAIL'}  {i['name']}: "
                        f"{i['detail']}" for i in doc["invariants"]))
    return {"verdict": "PASS", "seconds": seconds, "rc": rc,
            "published": doc["published"], "injected": doc["injected"],
            "invariants": [i["name"] for i in doc["invariants"]]}


def _twin_fleet(d: str) -> dict:
    """(c) the fleet's ticks folded by a TwinService on a durable broker,
    the CAR_TWIN changelog rolled and compacted, a second service rebuilt
    from it (its snapshot byte-equal to the first's), and GET /twin/<car>
    over the connect REST for TWIN_QUERIES cars, each equal to the
    table's document."""
    broker = Broker(store_dir=d, store_policy=StorePolicy())
    broker.create_topic(STORE_TOPIC, partitions=TWIN_PARTITIONS)
    scenario = FleetScenario(num_cars=TWIN_CARS, seed=7)
    gen = FleetGenerator(scenario)
    codec = native.NativeCodec(KSQL_CAR_SCHEMA)
    svc = TwinService(broker)
    publish_s = fold_s = 0.0
    published = 0
    for _ in range(TWIN_TICKS):
        # set-up in bulk: the records ``FleetGenerator.publish`` appends
        # (keys, values, the tick's ms, crc32 partitions), one
        # ``produce_many`` a tick
        t0 = time.perf_counter()
        cols = gen.step_columns()
        msgs = codec.encode_batch(
            gen.sensor_matrix(cols),
            cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
        ts = int(gen.t * 1000)
        broker.produce_many(STORE_TOPIC, [
            (scenario.car_id(int(car)).encode(), m, ts)
            for car, m in zip(cols["car"], msgs)])
        published += len(msgs)
        t1 = time.perf_counter()
        while svc.pump_once():
            pass
        publish_s += t1 - t0
        fold_s += time.perf_counter() - t1
    if svc.applied != published or len(svc.table) != TWIN_CARS:
        raise AssertionError(f"twin_path (c): folded {svc.applied} of "
                             f"{published} records into "
                             f"{len(svc.table)} cars")
    t0 = time.perf_counter()
    for p in range(TWIN_PARTITIONS):
        broker.store.log_for(CHANGELOG_TOPIC, p).roll()
    stats = broker.run_compaction(force=True)
    compact_s = time.perf_counter() - t0
    removed = sum(st.records_removed for st in stats.values())
    t0 = time.perf_counter()
    svc2 = TwinService(broker, group="iotml-twin-rebuilt")
    rebuild_s = time.perf_counter() - t0
    snapshot = svc.table.snapshot()
    if svc2.table.snapshot() != snapshot or removed <= 0 or \
            svc2.rebuilt_records != TWIN_CARS:
        raise AssertionError(
            f"twin_path (c): the rebuild from {svc2.rebuilt_records} "
            f"changelog records (compaction removed {removed}) is not "
            f"byte-equal to the folded table")
    srv = ConnectServer(ConnectWorker(broker)).start()
    lat = []
    try:
        srv.attach_twin(svc2)
        host, port = srv.url.split("//")[1].rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        try:
            for i in range(0, TWIN_CARS, TWIN_CARS // TWIN_QUERIES):
                car = scenario.car_id(i)
                t0 = time.perf_counter()
                conn.request("GET", f"/twin/{car}")
                r = conn.getresponse()
                doc = json.loads(r.read())
                lat.append(time.perf_counter() - t0)
                if r.status != 200 or doc != svc2.get(car):
                    raise AssertionError(f"twin_path (c): GET /twin/{car} "
                                         f"answered {r.status}: {doc}")
        finally:
            conn.close()
    finally:
        srv.stop()
    q = np.percentile(np.array(lat) * 1e3, [50, 99])
    return {"broker": broker, "svc": svc2,
            "info": {"cars": TWIN_CARS, "ticks": TWIN_TICKS,
                     "partitions": TWIN_PARTITIONS, "published": published,
                     "publish_s": publish_s, "fold_s": fold_s,
                     "fold_records_per_s": published / fold_s,
                     "changelog_records": svc.emitted,
                     "compaction_s": compact_s,
                     "compaction_records_removed": removed,
                     "rebuild_s": rebuild_s,
                     "rebuilt_records": svc2.rebuilt_records,
                     "rebuild_records_per_s":
                         svc2.rebuilt_records / rebuild_s,
                     "snapshot_bytes": sum(len(v)
                                           for v in snapshot.values()),
                     "snapshot_byte_equal": True,
                     "rest_queries": len(lat), "rest_equal": len(lat),
                     "query_p50_ms": float(q[0]),
                     "query_p99_ms": float(q[1])}}


def _twin_joined(bs, fs):
    """The batches with each live row joined to its car's twin features,
    as ``StreamScorer`` joins them."""
    return [dataclasses.replace(b, x=np.concatenate(
        [b.x, fs.matrix(b.keys, b.x.shape[0])], axis=1).astype(b.x.dtype))
        for b in bs]


def _twin_fit(broker, fs) -> dict:
    """(d) the joined model's fit on the card: ``fit_compiled`` over the
    first TWIN_FIT_BATCHES batches of 100 normal rows, joined, for
    TWIN_FIT_EPOCHS epochs (exactly one B1 launch, through "elements":
    the counts are 0 just before), held against the plain version at the
    fit bounds; the plain version and the kernel timed on the same
    inputs."""
    specs = [f"{STORE_TOPIC}:{p}:0" for p in range(TWIN_PARTITIONS)]
    bs = _twin_joined(list(SensorBatches(
        StreamConsumer(broker, specs, group="twin-fit"), batch_size=100,
        take=TWIN_FIT_BATCHES, only_normal=True, keep_keys=True)), fs)
    F = bs[0].x.shape[1]
    spec = AutoencoderSpec(input_dim=F)
    design = fused_train.fit_design(100, F, spec.encoding_dim,
                                    spec.hidden_dim)
    trainer = Trainer(spec)  # the card
    trainer._ensure_state()
    before = _clone_state(trainer.state)
    reset_fit_launches()
    t0 = time.perf_counter()
    hist = trainer.fit_compiled(bs, epochs=TWIN_FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if design != "elements" or launches != 1 or by_design["elements"] != 1:
        raise AssertionError(f"twin_path (d): the joined fit at F={F} "
                             f"launched B1 {launches}x ({by_design}), "
                             f"design {design}, not once through elements")
    xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_state, p_loss, p_acc = fused_train.fused_fit_reference(
        before, xs, masks, TWIN_FIT_EPOCHS)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    steps = len(bs) * TWIN_FIT_EPOCHS
    err = check_fit("twin_path (d) joined fit",
                    (trainer.state, torch.tensor(hist["loss"]),
                     torch.tensor(hist["accuracy"])),
                    (p_state, p_loss.cpu(), p_acc.cpu()), steps)
    kernel_ms = cuda_ms(lambda: fused_train.fused_fit(
        before, xs, masks, TWIN_FIT_EPOCHS), reps=3)
    bound = fit_bound(len(bs), 100, F, spec.encoding_dim, spec.hidden_dim,
                      TWIN_FIT_EPOCHS)
    return {"trainer": trainer, "batches": bs, "launches": launches,
            "launches_by_design": by_design, "max_abs_err": err,
            "info": {"shape": [F, spec.encoding_dim, spec.hidden_dim],
                     "batches": len(bs), "batch": 100,
                     "epochs": TWIN_FIT_EPOCHS, "design": design,
                     "fit_ms": 1e3 * fit_s, "kernel_ms": kernel_ms,
                     "us_per_step": 1e3 * kernel_ms / steps,
                     "plain_ms": plain_ms, **bound,
                     "loss_first": hist["loss"][0],
                     "loss_last": hist["loss"][-1],
                     "max_abs_err": err, "b1_launches": launches,
                     "b1_launches_by_design": by_design}}


def _twin_score(broker, params, threshold: float, spec, topic: str,
                group: str, feature_store) -> tuple:
    """One drain of every record through ``StreamScorer`` on the card:
    (payloads, rows/s)."""
    specs = [f"{STORE_TOPIC}:{p}:0" for p in range(TWIN_PARTITIONS)]
    broker.create_topic(topic)
    scorer = StreamScorer(
        spec, params,
        SensorBatches(StreamConsumer(broker, specs, group=group),
                      batch_size=100, keep_keys=True),
        OutputSequence(broker, topic, partition=0),
        feature_store=feature_store, verdict_mask=np.ones(18, bool),
        threshold=threshold)
    t0 = time.perf_counter()
    n = scorer.score_available()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = TWIN_CARS * TWIN_TICKS
    if n != want or broker.end_offset(topic, 0) != want:
        raise AssertionError(f"twin_path (e): scored {n} rows, "
                             f"{broker.end_offset(topic, 0)} on {topic}, "
                             f"published {want}")
    payloads = [m.value.decode() for m in broker.fetch(topic, 0, 0,
                                                       want + 1)]
    return payloads, n / seconds


def _twin_serve(broker, fs, fit: dict) -> dict:
    """(e) the joined scorer on the card over every record, payloads and
    errors against a CPU recompute of the same joined rows from the same
    params, its printed errors the mean over the live columns only; then
    the same scorer unjoined (18 wide, fresh weights) over the same rows,
    the join's cost."""
    specs = [f"{STORE_TOPIC}:{p}:0" for p in range(TWIN_PARTITIONS)]
    params = fit["trainer"].state.params
    F = fit["batches"][0].x.shape[1]
    spec = AutoencoderSpec(input_dim=F)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    x = np.concatenate([b.x[:b.n_valid] for b in _twin_joined(
        SensorBatches(StreamConsumer(broker, specs, group="twin-recompute"),
                      batch_size=100, keep_keys=True), fs)])
    with torch.no_grad():
        want = torch.func.functional_call(
            spec.build("cpu"), cpu_params, (torch.from_numpy(x),)).numpy()
    live = np.square(want[:, :18] - x[:, :18]).mean(axis=1)
    joined = np.square(want - x).mean(axis=1)
    threshold = float(np.percentile(live, 99.0))
    reset_launches()
    reset_fit_launches()
    payloads, rows_s = _twin_score(broker, params, threshold, spec,
                                   "model-predictions", "twin-serve", fs)
    if any(path_launches().values()):
        raise AssertionError(f"twin_path (e): the scorer launched "
                             f"{path_launches()}")
    rows, verdicts, errs = _payload_parts(payloads)
    if rows.shape != want.shape or not np.isfinite(rows).all():
        raise AssertionError(f"twin_path (e): payload rows {rows.shape}, "
                             f"want {want.shape}")
    err_first = float(np.abs(rows[:100] - want[:100]).max())
    err_all = float(np.abs(rows - want).max())
    if not np.allclose(rows[:100], want[:100], **CLI_TOL_FIRST) \
            or not np.allclose(rows, want, **CLI_TOL_ALL):
        raise AssertionError(f"twin_path (e): payloads disagree with a CPU "
                             f"recompute: first 100 max {err_first}, all "
                             f"max {err_all}")
    # the printed error is the live columns' mean (six decimals), not the
    # joined row's, and the verdicts follow it
    flipped = [v != ("anomaly" if e > threshold else "normal")
               for v, e in zip(verdicts, errs) if abs(e - threshold) > 1e-6]
    live_diff = float(np.abs(errs - live).max())
    joined_diff = float(np.abs(errs - joined).max())
    if any(flipped) or live_diff > 2e-6 or joined_diff <= 1e-4:
        raise AssertionError(
            f"twin_path (e): printed errors {live_diff} from the live "
            f"columns' mean, {joined_diff} from the joined row's, "
            f"{sum(flipped)} verdicts flipped")
    base = Trainer(CAR_AUTOENCODER)  # unjoined weights, never fitted
    base._ensure_state()
    _, unjoined_rows_s = _twin_score(broker, base.state.params, threshold,
                                     CAR_AUTOENCODER,
                                     "model-predictions-unjoined",
                                     "twin-serve-unjoined", None)
    return {"rows_scored": len(payloads), "threshold": threshold,
            "anomalies": verdicts.count("anomaly"),
            "payload_max_err_first_100": err_first,
            "payload_max_err_all": err_all,
            "printed_err_vs_live_mean": live_diff,
            "printed_err_vs_joined_mean": joined_diff,
            "rows_per_s_joined": rows_s,
            "rows_per_s_unjoined": unjoined_rows_s}


def phase_twin_path(card: str, root: str) -> dict:
    """The sinks and the digital twin (ROADMAP A16a) on the card: (a) the
    twin-rebuild drill through its CLI, (b) compaction-under-crash
    through the chaos CLI, (c) the twin at the reference's fleet size,
    (d) the joined model's fit (one B1 launch, "elements"), (e) the
    joined scorer.  The launch counts are 0 just before (d) and read just
    after it; (a), (b) and (e) launch no kernel."""
    t_phase = time.perf_counter()
    reset_launches()
    reset_fit_launches()
    a = _twin_drill_cli()
    b = _twin_chaos()
    if any(path_launches().values()):
        raise AssertionError(f"twin_path (a, b) launched "
                             f"{path_launches()}")
    d = str(Path(root) / "twin-store")
    c = _twin_fleet(d)
    fs = TwinFeatureStore(c["svc"])
    fit = _twin_fit(c["broker"], fs)
    e = _twin_serve(c["broker"], fs, fit)
    c["broker"].close()
    shutil.rmtree(d, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "twin_path", "card": card, "drill": a, "chaos": b,
          "fleet": c["info"], "fit": fit["info"], "serve": e,
          "phase_seconds": phase_s, "kernel_launches": fit["launches"],
          "kernel_launches_by_design": fit["launches_by_design"]})
    return {"launches": fit["launches"],
            "launches_by_design": fit["launches_by_design"],
            "max_abs_err": fit["max_abs_err"], "fit": fit["info"]}


# ----------------------------------------------------------- gateway_path
#: deploy/smoke.sh's drill (which it runs three times; once here, since
#: the three runs are identical) and .github/workflows/gateway.yml's (one,
#: with --json)
GATEWAY_DRILLS = (
    ["drill", "--seed", "7", "--records", "1500", "--cars", "30"],
    ["drill", "--seed", "11", "--records", "2000", "--cars", "40", "--json"])
GATEWAY_INVARIANTS = ("standby_byte_identical", "promote_within_slo",
                      "zero_wrong_answers", "bounded_staleness",
                      "fanout_agrees", "scorer_join_matches")
#: the fleet at the CLI's defaults: 100,000 cars, 2 fronts, 2 ticks,
#: 2 shards, 8 partitions, seed 20
GATEWAY_FLEET_ARGV = ["fleet"]
GATEWAY_FLEET_CARS = 100_000
GATEWAY_FLEET_TICKS = 2
#: (c): the sharded join's fleet, served by 2 shards with standbys
GATEWAY_CARS = 20_000
GATEWAY_TICKS = 2
GATEWAY_PARTITIONS = 8
GATEWAY_SHARDS = 2
#: the joined fits: the main path's slice of batches and epochs
GATEWAY_FIT_BATCHES = 100
GATEWAY_FIT_EPOCHS = 20
#: each await of (c) (the shards folding 40,000 records) ends here
GATEWAY_WAIT_S = 300.0


def _gateway_drill(argv) -> dict:
    """One ``python -m iotml_torch.gateway drill`` through its ``main`` in
    this process: exit 0 and all six invariants PASS."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = gateway_cli(list(argv))
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    if "--json" in argv:
        doc = json.loads(text)
        names = [i["name"] for i in doc["invariants"] if i["ok"]]
        info = {"published": doc["published"],
                "storm_queries": doc["storm_queries"],
                "storm_p99_ms": doc["storm_p99_ms"],
                "promote_s": doc["slos"]["promote_s"],
                "staleness_s": doc["slos"]["staleness_s"],
                "delta_replay_records": doc["promote_catchup_records"]}
    else:
        lines = text.splitlines()
        names = [line.split()[1].rstrip(":") for line in lines[1:]
                 if line.strip().startswith("PASS")]
        fields = dict(kv.split("=", 1) for kv in lines[0].split()[2:])
        replay = re.search(r"delta replay (\d+) records", text)
        info = {"published": int(fields["published"]),
                "storm_queries": int(fields["storm_queries"]),
                "storm_p99_ms": float(fields["storm_p99_ms"]),
                "promote_s": float(fields["promote_s"]),
                "staleness_s": float(fields["staleness_s"]),
                "delta_replay_records": int(replay.group(1))}
    if rc != 0 or tuple(names) != GATEWAY_INVARIANTS:
        raise AssertionError(f"gateway_path (a): {' '.join(argv)} exited "
                             f"{rc}:\n{text}")
    return {"argv": " ".join(argv), "rc": rc, "seconds": seconds,
            "invariants_passed": len(names), **info}


def _gateway_fleet() -> dict:
    """(b) ``python -m iotml_torch.gateway fleet`` at its defaults through
    its ``main``: every record folded, every car served, the lookups of
    each front answered, both fronts native and the payloads encoded by
    ``NativeCodec``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = gateway_cli(GATEWAY_FLEET_ARGV)
    doc = json.loads(out.getvalue())
    want = GATEWAY_FLEET_CARS * GATEWAY_FLEET_TICKS
    if rc != 0 or not doc["ok"] or doc["published"] != want or \
            doc["folded"] != want or \
            doc["fleet_cars_served"] != GATEWAY_FLEET_CARS or \
            not all(doc["per_front_lookups_ok"]) or \
            doc["native_fronts"] != doc["fronts"] or doc["fronts"] != 2 or \
            doc["codec"] != "native":
        raise AssertionError(f"gateway_path (b): the fleet exited {rc}: "
                             f"{doc}")
    return {**doc, "folded_records_per_s": doc["folded"] / doc["elapsed_s"]}


def _gateway_publish(broker) -> int:
    """GATEWAY_CARS x GATEWAY_TICKS framed-Avro records (seed 7) into
    SENSOR_DATA_S_AVRO, keyed by car (the broker's crc32 partitioner),
    made in bulk: one encode and one ``produce_many`` a tick."""
    broker.create_topic(STORE_TOPIC, partitions=GATEWAY_PARTITIONS)
    scenario = FleetScenario(num_cars=GATEWAY_CARS, seed=7)
    gen = FleetGenerator(scenario)
    codec = native.NativeCodec(KSQL_CAR_SCHEMA)
    published = 0
    for _ in range(GATEWAY_TICKS):
        cols = gen.step_columns()
        msgs = codec.encode_batch(
            gen.sensor_matrix(cols),
            cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
        ts = int(gen.t * 1000)
        broker.produce_many(STORE_TOPIC, [
            (scenario.car_id(int(car)).encode(), m, ts)
            for car, m in zip(cols["car"], msgs)])
        published += len(msgs)
    return published


def _gateway_await(cond, what: str) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > GATEWAY_WAIT_S:
            raise AssertionError(f"gateway_path (c): {what} not reached in "
                                 f"{GATEWAY_WAIT_S} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _gateway_batches(broker, group: str, **kw):
    specs = [f"{STORE_TOPIC}:{p}:0" for p in range(GATEWAY_PARTITIONS)]
    return SensorBatches(StreamConsumer(broker, specs, group=group),
                         batch_size=100, keep_keys=True, **kw)


def _gateway_matrices(broker, client, fs) -> dict:
    """``GatewayClient.matrix`` against ``TwinFeatureStore.matrix`` for
    every batch's keys, bit for bit."""
    batches = rows = 0
    t_remote = t_local = 0.0
    for b in _gateway_batches(broker, "gw-matrix"):
        t0 = time.perf_counter()
        remote = client.matrix(b.keys, b.x.shape[0])
        t1 = time.perf_counter()
        local = fs.matrix(b.keys, b.x.shape[0])
        t_local += time.perf_counter() - t1
        t_remote += t1 - t0
        if remote.dtype != np.float32 or not np.array_equal(
                remote.view(np.uint32), local.view(np.uint32)):
            raise AssertionError(f"gateway_path (c): GatewayClient.matrix "
                                 f"differs from TwinFeatureStore.matrix at "
                                 f"batch {batches}")
        batches += 1
        rows += b.n_valid
    if rows != GATEWAY_CARS * GATEWAY_TICKS:
        raise AssertionError(f"gateway_path (c): {rows} rows matched")
    return {"batches": batches, "rows": rows, "bit_equal": True,
            "remote_ms_per_batch": 1e3 * t_remote / batches,
            "local_ms_per_batch": 1e3 * t_local / batches}


def _gateway_fits(broker, client, fs) -> dict:
    """The joined model fit once through each feature store from one
    start state: exactly two B1 launches, both "elements" (the counts 0
    just before), params bit-equal, the gateway-joined fit held against
    the plain version (``check_fit``)."""
    joined = {}
    for name, store in (("gateway", client), ("local", fs)):
        joined[name] = _twin_joined(list(_gateway_batches(
            broker, f"gw-fit-{name}", take=GATEWAY_FIT_BATCHES,
            only_normal=True)), store)
    F = joined["gateway"][0].x.shape[1]
    spec = AutoencoderSpec(input_dim=F)
    design = fused_train.fit_design(100, F, spec.encoding_dim,
                                    spec.hidden_dim)
    start = Trainer(spec)  # the card
    start._ensure_state()
    before = _clone_state(start.state)
    trainers, hists = {}, {}
    reset_launches()
    reset_fit_launches()
    for name in ("gateway", "local"):
        trainers[name] = Trainer(spec)
        trainers[name].state = _clone_state(before)
        hists[name] = trainers[name].fit_compiled(joined[name],
                                                  epochs=GATEWAY_FIT_EPOCHS)
    torch.cuda.synchronize()
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    flash = {k: n for k, n in path_launches().items() if k != "fused_fit"}
    if design != "elements" or launches != 2 or by_design["elements"] != 2 \
            or any(flash.values()):
        raise AssertionError(f"gateway_path (c): the two joined fits at "
                             f"F={F} launched B1 {launches}x ({by_design}, "
                             f"design {design}), flash {flash}")
    for key in PARAM_NAMES:
        a = trainers["gateway"].state.params[key]
        b = trainers["local"].state.params[key]
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"gateway_path (c): the fit through the "
                                 f"gateway differs from the local fit in "
                                 f"{key}")
    bs = joined["gateway"]
    xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
    p_state, p_loss, p_acc = fused_train.fused_fit_reference(
        before, xs, masks, GATEWAY_FIT_EPOCHS)
    steps = len(bs) * GATEWAY_FIT_EPOCHS
    hist = hists["gateway"]
    err = check_fit("gateway_path (c) gateway-joined fit",
                    (trainers["gateway"].state, torch.tensor(hist["loss"]),
                     torch.tensor(hist["accuracy"])),
                    (p_state, p_loss.cpu(), p_acc.cpu()), steps)
    return {"trainer": trainers["gateway"], "batches": bs,
            "launches": launches, "launches_by_design": by_design,
            "max_abs_err": err,
            "info": {"shape": [F, spec.encoding_dim, spec.hidden_dim],
                     "batches": len(bs), "epochs": GATEWAY_FIT_EPOCHS,
                     "design": design, "b1_launches": launches,
                     "b1_launches_by_design": by_design,
                     "params_bit_equal": True,
                     "loss_first": hist["loss"][0],
                     "loss_last": hist["loss"][-1], "max_abs_err": err}}


def _gateway_score(broker, cluster, store, params, spec, threshold: float,
                   topic: str, kill: bool) -> tuple:
    """Every record through ``StreamScorer(feature_store=store)`` on the
    card, in two calls: the first stops at the first super-batch that
    reaches half the rows (25,600 of 40,000 at 128 batches a super-batch),
    the second drains the rest; with ``kill``, shard 0 is killed and its
    standby promoted between them.  (payloads, rows/s,
    the failover's numbers or None)"""
    want = GATEWAY_CARS * GATEWAY_TICKS
    broker.create_topic(topic)
    scorer = StreamScorer(
        spec, params, _gateway_batches(broker, f"gw-{topic}"),
        OutputSequence(broker, topic, partition=0), feature_store=store,
        verdict_mask=np.ones(18, bool), threshold=threshold)
    failover = None
    t0 = time.perf_counter()
    n = scorer.score_available(max_rows=want // 2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if kill:
        if not 0 < n < want:
            raise AssertionError(f"gateway_path (c): the kill would land "
                                 f"after {n} of {want} rows, not mid-drain")
        old_url, refreshes = cluster.shards[0].url, store.refreshes
        cluster.kill_shard(0)
        failover = {"rows_before_kill": n,
                    "promote_s": cluster.promote(0),
                    "new_url": cluster.shards[0].url != old_url}
    t0 = time.perf_counter()
    n += scorer.score_available()
    torch.cuda.synchronize()
    seconds += time.perf_counter() - t0
    if kill:
        failover["client_refreshes"] = store.refreshes - refreshes
    if n != want or broker.end_offset(topic, 0) != want:
        raise AssertionError(f"gateway_path (c): scored {n} rows, "
                             f"{broker.end_offset(topic, 0)} on {topic}, "
                             f"published {want}")
    payloads = [m.value for m in broker.fetch(topic, 0, 0, want + 1)]
    return payloads, n / seconds, failover


def _gateway_serve(broker, cluster, client, fs, fit: dict) -> dict:
    """The joined scorer through ``GatewayClient`` across a kill and
    promotion of shard 0, its payloads byte-equal to the same scorer's
    through the local ``TwinFeatureStore`` (same rows, same params, same
    calls), the first 100 rows against a CPU recompute."""
    params = fit["trainer"].state.params
    F = fit["batches"][0].x.shape[1]
    spec = AutoencoderSpec(input_dim=F)
    x = np.concatenate([b.x[:b.n_valid] for b in _twin_joined(
        list(_gateway_batches(broker, "gw-recompute", take=10)), fs)])
    with torch.no_grad():
        want = torch.func.functional_call(
            spec.build("cpu"), {k: v.cpu() for k, v in params.items()},
            (torch.from_numpy(x),)).numpy()
    threshold = float(np.percentile(
        np.square(want[:, :18] - x[:, :18]).mean(axis=1), 99.0))
    reset_launches()
    reset_fit_launches()
    remote, remote_rows_s, failover = _gateway_score(
        broker, cluster, client, params, spec, threshold,
        "model-predictions", kill=True)
    local, local_rows_s, _ = _gateway_score(
        broker, cluster, fs, params, spec, threshold,
        "model-predictions-local", kill=False)
    if any(path_launches().values()):
        raise AssertionError(f"gateway_path (c): the scorers launched "
                             f"{path_launches()}")
    differ = sum(a != b for a, b in zip(remote, local))
    if differ or len(remote) != len(local):
        raise AssertionError(f"gateway_path (c): {differ} payloads through "
                             f"the gateway differ from the local join's")
    rows, verdicts, _ = _payload_parts([p.decode() for p in remote[:100]])
    err_first = float(np.abs(rows - want[:100]).max())
    if not np.allclose(rows, want[:100], **CLI_TOL_FIRST):
        raise AssertionError(f"gateway_path (c): the first 100 payloads are "
                             f"{err_first} from a CPU recompute")
    return {"rows_scored": len(remote), "payloads_byte_equal": True,
            "threshold": threshold, "failover": failover,
            "payload_max_err_first_100": err_first,
            "rows_per_s_gateway": remote_rows_s,
            "rows_per_s_local": local_rows_s}


def _gateway_join() -> dict:
    """(c) the sharded join: GATEWAY_CARS x GATEWAY_TICKS records served
    by a ``GatewayCluster`` of GATEWAY_SHARDS shards with standbys and by
    a reference ``TwinService(changelog=False)``; matrices, the two fits
    and the scorer across a shard kill."""
    broker = Broker()
    published = _gateway_publish(broker)
    t0 = time.perf_counter()
    cluster = GatewayCluster(broker, n_shards=GATEWAY_SHARDS,
                             source_topic=STORE_TOPIC).start()
    client = GatewayClient(cluster)
    try:
        ref = TwinService(broker, source_topic=STORE_TOPIC,
                          group="gw-smoke-ref", changelog=False)
        while ref.pump_once():
            pass
        fs = TwinFeatureStore(ref)
        _gateway_await(lambda: client.aggregate()["records"] >= published,
                       "the shards' fold")
        _gateway_await(lambda: gateway_drill.sources_committed(cluster),
                       "the shards' commits")
        _gateway_await(lambda: all(s.lag() == 0
                                   for s in cluster.standbys.values()),
                       "the standbys' catch-up")
        fold_s = time.perf_counter() - t0
        if client.count() != GATEWAY_CARS or ref.applied != published:
            raise AssertionError(f"gateway_path (c): {client.count()} cars "
                                 f"served, {ref.applied} folded by the "
                                 f"reference of {published}")
        matrices = _gateway_matrices(broker, client, fs)
        fit = _gateway_fits(broker, client, fs)
        serve = _gateway_serve(broker, cluster, client, fs, fit)
    finally:
        client.close()
        cluster.stop()
        broker.close()
    return {"launches": fit["launches"],
            "launches_by_design": fit["launches_by_design"],
            "max_abs_err": fit["max_abs_err"],
            "info": {"cars": GATEWAY_CARS, "ticks": GATEWAY_TICKS,
                     "partitions": GATEWAY_PARTITIONS,
                     "shards": GATEWAY_SHARDS, "published": published,
                     "fold_and_catch_up_s": fold_s,
                     "matrices": matrices, "fit": fit["info"],
                     "serve": serve}}


def phase_gateway_path(card: str) -> dict:
    """The gateway serving plane (ROADMAP A16b) on the card: (a) the
    shard-kill drill through its CLI twice, (b) the federated fleet
    at 100,000 cars through its CLI, (c) the sharded join (matrices, two
    B1 launches, the scorer across a shard kill).  The launch counts are
    0 just before (c)'s fits and read just after them; (a), (b) and (c)'s
    scorers launch no kernel."""
    t_phase = time.perf_counter()
    reset_launches()
    reset_fit_launches()
    drills = [_gateway_drill(argv) for argv in GATEWAY_DRILLS]
    t_fleet = time.perf_counter()
    fleet = _gateway_fleet()
    fleet_s = time.perf_counter() - t_fleet
    if any(path_launches().values()) or fused_train.fused_fit.launches:
        raise AssertionError(f"gateway_path (a, b) launched "
                             f"{path_launches()}")
    t_join = time.perf_counter()
    join = _gateway_join()
    join_s = time.perf_counter() - t_join
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "gateway_path", "card": card, "drills": drills,
          "fleet": fleet, "join": join["info"],
          "seconds": {"drills": t_fleet - t_phase, "fleet": fleet_s,
                      "join": join_s},
          "phase_seconds": phase_s, "kernel_launches": join["launches"],
          "kernel_launches_by_design": join["launches_by_design"]})
    return {"launches": join["launches"],
            "launches_by_design": join["launches_by_design"],
            "max_abs_err": join["max_abs_err"]}



# ---------------------------------------------------------- analysis_path
#: (b): the guarded fits' epochs (the main path's)
ANALYSIS_FIT_EPOCHS = 20
#: (c): the lockcheck child's fleet, drained through the wire
ANALYSIS_CARS, ANALYSIS_TICKS, ANALYSIS_PARTITIONS = 100, 30, 2
ANALYSIS_GROUP = "analysis-lockcheck"


def _analysis_children() -> dict:
    """(a)'s two CLI runs and (c)'s lockcheck child, started together."""
    here = str(Path(__file__).parent)
    run = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
               cwd=here)
    return {
        "all": subprocess.Popen([sys.executable, "-m",
                                 "iotml_torch.analysis", "all"], **run),
        "lockorder": subprocess.Popen([sys.executable, "-m",
                                       "iotml_torch.analysis",
                                       "lockorder"], **run),
        "lockcheck": subprocess.Popen([sys.executable, __file__,
                                       "--analysis-lockcheck-child"], **run)}


def _analysis_wait(procs: dict) -> tuple:
    """Each child's (returncode, stdout, stderr); a child still running
    after 300 s is killed and fails the phase."""
    done = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.wait()
            raise AssertionError(f"analysis_path: the {name} child ran "
                                 f"past 300 s")
        done[name] = (proc.returncode, out, err)
    return done


def _analysis_static(done: dict) -> dict:
    """(a): both CLI runs exit 0 with 0 findings / 0 static cycles."""
    out = {}
    for verb in ("all", "lockorder"):
        rc, stdout, stderr = done[verb]
        summary = stderr.strip().splitlines()[-1] if stderr.strip() else ""
        parsed = re.search(r"(\d+) file\(s\) parsed once, ([0-9.]+)s wall",
                           summary)
        counted = re.search(r"(\d+) (finding|static cycle)", summary)
        if rc != 0 or not parsed or not counted or counted.group(1) != "0" \
                or (verb == "all" and stdout.strip()):
            raise AssertionError(f"analysis_path (a): `python -m "
                                 f"iotml_torch.analysis {verb}` exited "
                                 f"{rc}:\n{stdout[-3000:]}\n{stderr[-2000:]}")
        out[verb] = {"rc": rc, "files_parsed": int(parsed.group(1)),
                     "wall_s": float(parsed.group(2)), "findings": 0}
        if verb == "lockorder":
            out[verb]["edges"] = len(stdout.strip().splitlines())
            out[verb]["static_cycles"] = 0
    return out


@contextlib.contextmanager
def _sync_calls():
    """Count the synchronizing CUDA calls in the block, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them; the count is
    in the yielded list after the block."""
    import warnings

    counted: list = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counted
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counted.append(sum("synchroniz" in str(w.message) for w in caught))


def _analysis_main_slice() -> list:
    """The main path's training slice, made anew: a batcher over a
    ``RowSource`` yields the next rows on each pass, and ``main_path``'s
    own batcher is read again by ``timing``."""
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    return list(SensorBatches(RowSource.from_fleet(gen, n_ticks=300),
                              batch_size=100, take=100, only_normal=True))


def _analysis_guarded() -> dict:
    """(b): the build guard over the two hot loops on the card."""
    bs = _analysis_main_slice()
    xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
    patched = tracecheck.install_runtime_guard()
    if sorted(patched) != ["OnlineLearner._update",
                           "ShardedStreamTrainer.fit_compiled",
                           "ShardedStreamTrainer.fit_round",
                           "Trainer.fit_compiled"]:
        tracecheck.uninstall_runtime_guard()
        raise AssertionError(f"analysis_path (b): the guard patched "
                             f"{patched}")
    try:
        trainer = Trainer(CAR_AUTOENCODER)  # the card
        trainer._ensure_state()
        learner = OnlineLearner(Broker(), "ANALYSIS_ONLINE", window=100)
        windows = [Batch(x=bs[i].x, n_valid=bs[i].n_valid,
                         first_index=100 * i) for i in (0, 1)]
        reset_launches()
        reset_fit_launches()
        fits, starts, ends = [], [], []
        for _ in range(2):
            starts.append(_clone_state(trainer.state))
            before = tracecheck.RecompileGuard.compiles()
            t0 = time.perf_counter()
            with _sync_calls() as syncs:
                hist = trainer.fit_compiled(bs, epochs=ANALYSIS_FIT_EPOCHS)
            torch.cuda.synchronize()
            fits.append({"hist": hist, "seconds": time.perf_counter() - t0,
                         "builds": tracecheck.RecompileGuard.compiles()
                         - before, "sync_calls": syncs[0]})
            ends.append(_clone_state(trainer.state))
        fit_launches = fused_train.fused_fit.launches
        by_design = dict(fused_train.fused_fit.launches_by_design)
        updates = []
        for w in windows:
            before = tracecheck.RecompileGuard.compiles()
            t0 = time.perf_counter()
            with _sync_calls() as syncs:
                loss = learner._update(w)
            updates.append({"loss": loss,
                            "seconds": time.perf_counter() - t0,
                            "builds": tracecheck.RecompileGuard.compiles()
                            - before, "sync_calls": syncs[0]})
        update_launches = fused_train.fused_fit.launches - fit_launches
        flash = {k: n for k, n in path_launches().items() if k != "fused_fit"}
    finally:
        tracecheck.uninstall_runtime_guard()
    warm_builds = [fits[1]["builds"], updates[1]["builds"]]
    if fit_launches != 2 or by_design["rows"] != 2 or update_launches \
            or any(flash.values()) or any(warm_builds) \
            or not all(math.isfinite(u["loss"]) for u in updates):
        raise AssertionError(f"analysis_path (b): B1 {fit_launches}x "
                             f"({by_design}), updates {update_launches}, "
                             f"flash {flash}, builds after warm-up "
                             f"{warm_builds}, update losses "
                             f"{[u['loss'] for u in updates]}")
    err = 0.0
    steps = len(bs) * ANALYSIS_FIT_EPOCHS
    for i, fit in enumerate(fits):
        p_state, p_loss, p_acc = fused_train.fused_fit_reference(
            starts[i], xs, masks, ANALYSIS_FIT_EPOCHS)
        err = max(err, check_fit(
            f"analysis_path (b) fit_compiled call {i + 1}",
            (ends[i], torch.tensor(fit["hist"]["loss"]),
             torch.tensor(fit["hist"]["accuracy"])),
            (p_state, p_loss.cpu(), p_acc.cpu()), (i + 1) * steps))
    return {"launches": fit_launches, "launches_by_design": by_design,
            "max_abs_err": err,
            "info": {"guarded": sorted(patched),
                     "fit_compiled": [{k: f[k] for k in (
                         "seconds", "builds", "sync_calls")}
                         | {"loss_first": f["hist"]["loss"][0],
                            "loss_last": f["hist"]["loss"][-1]}
                         for f in fits],
                     "online_update": updates,
                     "builds_after_warm_up": sum(warm_builds),
                     "b1_launches": fit_launches,
                     "b1_launches_by_design": by_design,
                     "update_launches": update_launches,
                     "max_abs_err": err}}


def analysis_lockcheck_child() -> dict:
    """(c), in its own process: the port's lockcheck installed and
    pre-seeded with the static edges before any broker exists, then one
    wire drain (``KafkaWireServer``, a wire ``GroupConsumer``, the card's
    ``StreamScorer``)."""
    st = lockcheck.install()
    seeded = lockorder.preseed(st)
    backing = Broker()
    n = FleetGenerator(FleetScenario(num_cars=ANALYSIS_CARS,
                                     failure_rate=0.01)).publish(
        backing, SERVE_TOPIC, n_ticks=ANALYSIS_TICKS,
        partitions=ANALYSIS_PARTITIONS)
    trainer = Trainer(CAR_AUTOENCODER)  # the card
    trainer._ensure_state()
    t0 = time.perf_counter()
    with KafkaWireServer(backing) as srv:
        client = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        try:
            consumer = GroupConsumer(
                RemoteGroupCoordinator(client, ANALYSIS_GROUP),
                [SERVE_TOPIC])
            out = OutputSequence()
            scorer = StreamScorer(CAR_AUTOENCODER, trainer.state.params,
                                  SensorBatches(consumer, batch_size=100),
                                  out, threshold=5.0)
            rows, rounds = 0, 0
            while rows < n and rounds < 50:
                rows += scorer.score_available()
                rounds += 1
        finally:
            client.close()
    seconds = time.perf_counter() - t0
    final = lockcheck.uninstall()
    kinds = collections.Counter(v.kind for v in final.violations)
    return {"records": n, "rows_scored": rows, "published":
            len(out.published), "drain_s": seconds, "seeded_edges": seeded,
            "edges": len(final.edges), "cycles": kinds.get("cycle", 0),
            "static_cycles": kinds.get("static-cycle", 0),
            "io_under_lock": kinds.get("io-under-lock", 0),
            "unguarded_mutation": kinds.get("unguarded-mutation", 0),
            "cycle_messages": [v.message for v in final.cycles()][:5]}


def _analysis_lockcheck(done: dict) -> dict:
    rc, stdout, stderr = done["lockcheck"]
    lines = stdout.strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"analysis_path (c): the lockcheck child "
                             f"exited {rc}:\n{stdout[-2000:]}\n"
                             f"{stderr[-3000:]}")
    info = json.loads(lines[-1])
    if info["cycles"] or info["rows_scored"] != info["records"] \
            or info["published"] != info["records"] \
            or info["records"] != ANALYSIS_CARS * ANALYSIS_TICKS:
        raise AssertionError(f"analysis_path (c): {info}")
    return info


def phase_analysis_path(card: str) -> dict:
    """The analysis tooling (ROADMAP A13) on the card's machine: (a) the
    static passes as child processes, (b) the build guard over the two
    hot loops on the card, (c) the runtime lockcheck over a wire drain in
    a child.  The launch counts are 0 just before (b)'s fits and read
    just after its updates."""
    t_phase = time.perf_counter()
    procs = _analysis_children()
    try:
        guarded = _analysis_guarded()
    except BaseException:
        for p in procs.values():
            p.kill()
            p.wait()
        raise
    t_wait = time.perf_counter()
    done = _analysis_wait(procs)
    static = _analysis_static(done)
    lock = _analysis_lockcheck(done)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "analysis_path", "card": card, "static": static,
          "guard": guarded["info"], "lockcheck": lock,
          "seconds": {"guarded": t_wait - t_phase,
                      "children_after_guarded": time.perf_counter()
                      - t_wait},
          "phase_seconds": phase_s,
          "kernel_launches": guarded["launches"],
          "kernel_launches_by_design": guarded["launches_by_design"]})
    return guarded


# -------------------------------------------------------------- mesh_path
#: the data-parallel bound of tests/test_parallel.py (losses and params)
MESH_TOL = dict(rtol=1e-4, atol=1e-6)
#: the online learner's per-device losses against a CPU recompute
MESH_CHIP_TOL = dict(rtol=1e-5, atol=0.0)
#: (a): the main slice's epochs (the reference job's 20, cut to 2)
MESH_FIT_EPOCHS = 2
#: (b): rounds, batches a feed a round, partitions, cars x ticks
MESH_ROUNDS, MESH_TAKE, MESH_PARTITIONS = 3, 10, 8
MESH_CARS, MESH_TICKS = 100, 80
#: (d): the rehearsal's steps and its wall limit
MESH_WORKER_STEPS, MESH_WORKER_TIMEOUT_S = 6, 300.0
#: (e): the CLI's epochs (its default 20, cut to 2)
MESH_CLI_EPOCHS = 2
#: (f): bench_leg's timed and warm records
MESH_BENCH_RECORDS, MESH_BENCH_WARMUP = 40_000, 8_000


def _card_shards(n: int = 2) -> list:
    return [torch.device("cuda", 0)] * n


def _mesh_of(devices) -> "parallel_mesh.Mesh":
    return parallel_mesh.make_mesh((len(devices),), ("data",),
                                   devices=devices)


def _mesh_step_profile(tr, batch, root: str) -> dict:
    """One warmed step of the two-shard ``ShardedTrainer`` ``tr`` on
    ``batch`` (its shards already on the card) in an ``obs.profile``
    capture: wall and device ms, busy share, CUDA launches, and the host
    ms in the shards' forwards (``_loss_fn``), their backwards
    (``torch.autograd.grad``) and the Adam updates, each wrapped in a
    named span for the capture alone; the rest of the step is the mask
    sum, the flat ``cat`` and sum, the split and the metrics."""
    x, _y, m = tr.put_batch(batch.x, batch.x, batch.mask)
    tr._step(x, x, m)  # this shape warmed
    loss_fn, grad = tr._loss_fn, torch.autograd.grad

    def spanned(name, fn):
        def call(*a, **k):
            with obs_profile.annotate(name):
                return fn(*a, **k)
        return call

    tr._loss_fn = spanned("mesh.forward", loss_fn)
    tr.tx.update = spanned("mesh.adam", tr.tx.update)
    torch.autograd.grad = spanned("mesh.backward", grad)
    try:
        with obs_profile.trace(f"{root}/mesh_step_profile") as cap:
            with obs_profile.annotate("mesh.step"):
                metrics = tr._step(x, x, m)
            float(metrics["loss"])
    finally:
        tr._loss_fn, torch.autograd.grad = loss_fn, grad
        del tr.tx.update
    with open(cap.path, encoding="utf-8") as fh:
        doc = json.load(fh)
    spans, launches = {}, 0
    for e in doc["traceEvents"] if isinstance(doc, dict) else doc:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("mesh."):
            n, us = spans.get(name, (0, 0.0))
            spans[name] = (n + 1, us + float(e.get("dur", 0.0)))
        elif e.get("cat") == "cuda_runtime" and "LaunchKernel" in name:
            launches += 1
    host = {k[5:]: {"count": n, "ms": us / 1e3}
            for k, (n, us) in sorted(spans.items())}
    step_ms = host.get("step", {}).get("ms", 0.0)
    host["rest"] = {"ms": step_ms - sum(
        host.get(k, {}).get("ms", 0.0)
        for k in ("forward", "backward", "adam"))}
    s = cap.summary(top=5)
    return {"shards": len(x.shards), "rows": int(batch.x.shape[0]),
            "step_ms": step_ms, "wall_ms_profiled": s["window_ms"],
            "cuda_launches": launches, "device_ops": s["device_ops"],
            "device_ms": s["device_ms"], "device_busy_share":
            s["busy_share"] if s["device_ops"] else None,
            "host_ms": host, "top": s["top"]}


def _mesh_fit(root: str) -> dict:
    """(a): ``ShardedTrainer.fit`` on two card shards against the
    single-device ``Trainer.fit`` of the same rows and init; ms a step
    for 1 and 2 shards; one warmed two-shard step profiled."""
    bs = _analysis_main_slice()
    runs, trainers = {}, {}
    for tag, make in (
            ("2 shards", lambda: ShardedTrainer(
                CAR_AUTOENCODER, _mesh_of(_card_shards(2)))),
            ("1 shard", lambda: ShardedTrainer(
                CAR_AUTOENCODER, _mesh_of(_card_shards(1)))),
            ("Trainer", lambda: Trainer(CAR_AUTOENCODER))):
        tr = trainers[tag] = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.fit(bs, epochs=MESH_FIT_EPOCHS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[tag] = (hist, tr.state, seconds)
    steps = len(bs) * MESH_FIT_EPOCHS
    (hist, state, _), (ref, ref_state, _) = runs["2 shards"], runs["Trainer"]
    err = check_close("mesh_path (a) losses", torch.tensor(hist["loss"]),
                      torch.tensor(ref["loss"]), **MESH_TOL)
    for key in PARAM_NAMES:
        err = max(err, check_close(f"mesh_path (a) {key}",
                                   state.params[key],
                                   ref_state.params[key], **MESH_TOL))
    if state.step != steps or not hist["loss"][-1] < hist["loss"][0]:
        raise AssertionError(f"mesh_path (a): step {state.step} of "
                             f"{steps}, losses {hist['loss']}")
    return {"batches": len(bs), "batch": 100, "epochs": MESH_FIT_EPOCHS,
            "steps": steps, "loss": hist["loss"], "max_abs_err": err,
            "ms_per_step": {tag: 1e3 * s / steps
                            for tag, (_h, _st, s) in runs.items()},
            "step_profile": _mesh_step_profile(trainers["2 shards"],
                                               bs[0], root)}


def _mesh_live(store_dir: str) -> dict:
    """(b): ``ContinuousTrainer(mesh=, device_normalize=True)`` over a
    durable broker with 8 partitions, registry mode: a manifest a round
    stamping all 8 cursors; each round's params against the same rounds
    on two CPU shards."""
    broker = Broker(store_dir=store_dir,
                    store_policy=StorePolicy(fsync="never"))
    try:
        n = FleetGenerator(FleetScenario(
            num_cars=MESH_CARS, failure_rate=0.01)).publish(
            broker, SERVE_TOPIC, n_ticks=MESH_TICKS,
            partitions=MESH_PARTITIONS)
        roots = {tag: tempfile.mkdtemp(prefix=f"chip_smoke_mesh_{tag}_")
                 for tag in ("card", "cpu")}
        trainers = {
            tag: ContinuousTrainer(
                broker, SERVE_TOPIC, None,
                registry=ModelRegistry(roots[tag]),
                group=f"mesh-live-{tag}", mesh=_mesh_of(devs),
                device_normalize=True, take_batches=MESH_TAKE,
                batch_size=100)
            for tag, devs in (("card", _card_shards(2)),
                              ("cpu", [torch.device("cpu")] * 2))}
        rounds, err = [], 0.0
        for r in range(MESH_ROUNDS):
            stats = {tag: tr.train_round() for tag, tr in trainers.items()}
            version = trainers["card"].checkpointer.write_once()
            trainers["cpu"].checkpointer.write_once()
            m = trainers["card"].registry.manifest(version)
            parts = sorted(p for _t, p, _o in m.offsets)
            if parts != list(range(MESH_PARTITIONS)) or \
                    stats["card"]["records"] != stats["cpu"]["records"] or \
                    not stats["card"]["records"]:
                raise AssertionError(f"mesh_path (b) round {r + 1}: "
                                     f"manifest partitions {parts}, "
                                     f"stats {stats}")
            err = max(err, check_close(
                f"mesh_path (b) round {r + 1} loss",
                torch.tensor([stats["card"]["loss"]]),
                torch.tensor([stats["cpu"]["loss"]]), **MESH_TOL))
            card_state = trainers["card"].trainer.state
            cpu_state = trainers["cpu"].trainer.state
            for key in PARAM_NAMES:
                err = max(err, check_close(
                    f"mesh_path (b) round {r + 1} {key}",
                    card_state.params[key], cpu_state.params[key],
                    **MESH_TOL))
            rounds.append({"round": r + 1, "version": version,
                           "records": stats["card"]["records"],
                           "loss": stats["card"]["loss"],
                           "seconds": stats["card"]["seconds"],
                           "manifest_partitions": len(parts)})
        manifests = len(trainers["card"].registry.versions())
        for tr in trainers.values():
            tr.close()
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)
        if manifests != MESH_ROUNDS:
            raise AssertionError(f"mesh_path (b): {manifests} manifests "
                                 f"for {MESH_ROUNDS} rounds")
        return {"records_published": n, "rounds": rounds,
                "manifests": manifests, "max_abs_err": err}
    finally:
        broker.close()


def _mesh_online() -> dict:
    """(c): ``OnlineLearner(mesh=, chip_monitors=)``, two windows, the
    global and per-device losses against a CPU learner's."""
    rng = np.random.default_rng(7)
    wins = [rng.normal(0, 0.1, (100, 18)).astype(np.float32)
            for _ in range(2)]
    wins[1][50:] += 3.0  # the second shard's rows off-distribution
    got = {}
    for tag, devs in (("card", _card_shards(2)),
                      ("cpu", [torch.device("cpu")] * 2)):
        lr = OnlineLearner(Broker(), "MESH_ONLINE", mesh=_mesh_of(devs),
                           device_normalize=True, window=100,
                           chip_monitors=[online_detectors.DriftMonitor()
                                          for _ in devs])
        got[tag] = [(lr._update(Batch(x=x, n_valid=100,
                                      first_index=100 * i)),
                     np.asarray(lr.last_chip_losses))
                    for i, x in enumerate(wins)]
    err = 0.0
    for i, ((loss, chips), (c_loss, c_chips)) in enumerate(
            zip(got["card"], got["cpu"])):
        err = max(err, check_close(
            f"mesh_path (c) window {i + 1}",
            torch.tensor([loss, *chips]),
            torch.tensor([c_loss, *c_chips]), **MESH_CHIP_TOL))
    return {"windows": [{"loss": loss, "chip_losses": chips.tolist()}
                        for loss, chips in got["card"]],
            "max_abs_err": err}


def _mesh_rehearsal_broker() -> Broker:
    broker = Broker()
    FleetGenerator(FleetScenario(num_cars=40, failure_rate=0.02)).publish(
        broker, "SENSOR", n_ticks=60, partitions=4)
    return broker


def _mesh_cpu_losses(broker, n_procs: int, shards: int) -> list:
    """The rehearsal's trajectory recomputed in this process on the CPU:
    each step's batch the ranks' batches in rank order."""
    per_rank = []
    for pid in range(n_procs):
        parts = parallel_distributed.assign_partitions(4, n_procs, pid)
        consumer = StreamConsumer(
            broker, parallel_distributed.consumer_specs("SENSOR", parts),
            group=f"mesh-recompute-{n_procs}-{pid}")
        per_rank.append(list(SensorBatches(consumer, batch_size=32,
                                           only_normal=True,
                                           pad_tail=False)))
    tr = ShardedTrainer(CAR_AUTOENCODER, _mesh_of(
        [torch.device("cpu")] * (n_procs * shards)))
    losses = []
    for i in range(MESH_WORKER_STEPS):
        bs = [r[i % len(r)] for r in per_rank]
        x = np.concatenate([b.x for b in bs])
        losses.append(float(tr.step(x, x, np.concatenate(
            [b.mask for b in bs]))["loss"]))
    return losses


def _mesh_rehearsals() -> dict:
    """(d): ``python -m iotml_torch.parallel.multihost_worker`` as two
    ranks on the one card over gloo (CUDA tensors), and as one rank over
    NCCL, started together."""
    cases = {"gloo 2 ranks": (2, "gloo"), "nccl 1 rank": (1, "nccl")}
    brokers = {tag: _mesh_rehearsal_broker() for tag in cases}
    with ThreadPoolExecutor(max_workers=len(cases)) as pool:
        futs = {tag: pool.submit(
            multihost_worker.spawn_rehearsal, steps=MESH_WORKER_STEPS,
            timeout=MESH_WORKER_TIMEOUT_S, n_partitions=4, n_procs=n,
            shards=2, device="cuda:0", backend=backend,
            broker=brokers[tag])
            for tag, (n, backend) in cases.items()}
        done = {tag: f.result() for tag, f in futs.items()}
    out, err = {}, 0.0
    for tag, (procs, outs) in done.items():
        n = cases[tag][0]
        trajs = []
        for pid, (p, text) in enumerate(zip(procs, outs)):
            ok = re.search(rf"MULTIHOST pid={pid}/{n} devices={2 * n} "
                           rf".* loss [\d.]+->[\d.]+ .* ok", text)
            if p.returncode != 0 or not ok:
                raise AssertionError(f"mesh_path (d) {tag} rank {pid} "
                                     f"exited {p.returncode}:\n"
                                     f"{text[-3000:]}")
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("MULTIHOST-LOSSES "))
            trajs.append(json.loads(line.split(" ", 1)[1]))
        if any(t != trajs[0] for t in trajs):
            raise AssertionError(f"mesh_path (d) {tag}: the ranks' "
                                 f"trajectories differ: {trajs}")
        err = max(err, check_close(
            f"mesh_path (d) {tag} vs the CPU", torch.tensor(trajs[0]),
            torch.tensor(_mesh_cpu_losses(brokers[tag], n, 2)),
            rtol=1e-4, atol=0.0))
        out[tag] = {"ranks": n, "shards_a_rank": 2, "losses": trajs[0],
                    "lines": [ln for text in outs
                              for ln in text.splitlines()
                              if ln.startswith("MULTIHOST pid=")]}
    return {"runs": out, "max_abs_err": err}


def _mesh_cli(root: str) -> dict:
    """(e): the cardata CLI's mesh train through ``main(argv,
    devices=[cuda:0, cuda:0])`` with ``--mesh.data=2``; and
    ``IOTML_MESH_DATA=2`` with the default device list, which on a
    one-card machine must refuse as JAX's CLI does."""
    argv = ["emulator:30000", SERVE_TOPIC, "0", "model-predictions",
            "train", "mesh-model", os.path.join(root, "mesh_cli"),
            "--mesh.data=2", f"--train.epochs={MESH_CLI_EPOCHS}"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cardata.main(argv, devices=_card_shards(2))
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    stats = json.loads(out.split("stats: ")[1].splitlines()[0]) \
        if "stats: " in out else {}
    losses = stats.get("loss", [])
    if rc != 0 or "mesh: {'data': 2, 'model': 1} over 2 devices" not in out \
            or stats.get("records") != 10_000 \
            or len(losses) != MESH_CLI_EPOCHS \
            or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"mesh_path (e): rc {rc}:\n{out[-3000:]}")
    refusal = None
    if torch.cuda.device_count() == 1:
        saved = os.environ.get("IOTML_MESH_DATA")
        os.environ["IOTML_MESH_DATA"] = "2"
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cardata.main(argv[:7] + ["--train.epochs=1"])
        except ValueError as e:
            refusal = str(e)
        finally:
            if saved is None:
                os.environ.pop("IOTML_MESH_DATA")
            else:
                os.environ["IOTML_MESH_DATA"] = saved
        if refusal != "mesh shape (2, 1) needs 2 devices, have 1":
            raise AssertionError(f"mesh_path (e): IOTML_MESH_DATA=2 on one "
                                 f"card gave {refusal!r}")
    return {"losses": losses, "records": stats["records"],
            "fit_seconds": stats["fit_seconds"], "seconds": seconds,
            "refusal": refusal}


def phase_mesh_path(card: str, root: str) -> dict:
    """Data parallelism (ROADMAP A10) on the card, ``[cuda:0, cuda:0]``
    as the data axis: (a) ``ShardedTrainer.fit``, (b) the live trainer's
    mesh rounds, (c) the online learner's per-device monitors, (f)
    ``bench_leg(2)``, then (d) the multi-process worker as child
    processes while (e) the CLI's mesh train runs.  The launch counts
    are 0 just before (a) and read just after (e): no kernel on this
    path."""
    t_phase = time.perf_counter()
    reset_launches()
    reset_fit_launches()
    fit = _mesh_fit(root)
    t_fit = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_store_")
    try:
        live = _mesh_live(store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    online = _mesh_online()
    t_bench = time.perf_counter()
    leg = parallel_streaming.bench_leg(
        2, records=MESH_BENCH_RECORDS, warmup_records=MESH_BENCH_WARMUP,
        devices=_card_shards(2))
    t_children = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        rehearsals = pool.submit(_mesh_rehearsals)
        cli = _mesh_cli(root)
        workers = rehearsals.result()
    launches = path_launches()
    if any(launches.values()):
        raise AssertionError(f"mesh_path: kernel launches {launches}")
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "mesh_path", "card": card, "shards": 2,
          "fit": fit, "live": live, "online": online,
          "rehearsals": workers["runs"], "cli": cli,
          "bench_leg": {**leg, "card": card, "note": "two logical shards "
                        "on one card; not a scaling figure"},
          "seconds": {"fit": t_fit - t_phase,
                      "live_online": t_bench - t_fit,
                      "bench_leg": t_children - t_bench,
                      "children_and_cli": time.perf_counter()
                      - t_children},
          "phase_seconds": phase_s, "kernel_launches": launches})
    return {"launches": launches["fused_fit"],
            "launches_by_design":
                dict(fused_train.fused_fit.launches_by_design),
            "max_abs_err": max(fit["max_abs_err"], live["max_abs_err"],
                               online["max_abs_err"],
                               workers["max_abs_err"])}


#: the Kaggle creditcard file's row count, which the synthetic file takes
CC_ROWS = 284_807
#: steps of the creditcard fit held against the plain version (the plain
#: version takes ~2 ms a step on the card: not all ~42,300)
CC_PREFIX_STEPS = 500
#: card scores against a CPU recompute from the same params
CC_SCORE_TOL = dict(rtol=1e-5, atol=0.0)


@contextlib.contextmanager
def _initial_states():
    """The state each ``Trainer`` starts its fit from, as it creates it."""
    real = Trainer._ensure_state
    states = []

    def ensure(self):
        fresh = self.state is None
        real(self)
        if fresh:
            states.append(self.state)

    Trainer._ensure_state = ensure
    try:
        yield states
    finally:
        Trainer._ensure_state = real


def ranking_tolerance(scores: np.ndarray, labels: np.ndarray,
                      rtol: float) -> dict:
    """How far AUC and AP may move when every score may move by ``rtol``
    of itself, so that two scores can swap or tie only when they lie
    within ``rtol·(|a| + |b|)`` of each other (the band):
    - AUC counts (anomaly, normal) pairs in order; each pair in a band
      moves it by at most 1 / (P·N);
    - AP is the mean over anomalies of k / r (anomalies, items at or
      above it): an item in an anomaly's band moves k or r by one, so
      that anomaly's term moves by at most (items in its band) / (r at
      its smallest: 1 + the items above its band); items outside every
      band keep their order against it."""
    s = np.asarray(scores, np.float64)
    lab = np.asarray(labels).astype(bool)
    anom, normal = s[lab], np.sort(s[~lab])
    all_sorted = np.sort(s)
    band = rtol * 2 * np.abs(anom) * 1.0001
    lo, hi = anom - band, anom + band
    pairs = (np.searchsorted(normal, hi, "right")
             - np.searchsorted(normal, lo, "left"))
    near = (np.searchsorted(all_sorted, hi, "right")
            - np.searchsorted(all_sorted, lo, "left")) - 1
    r_min = 1 + len(s) - np.searchsorted(all_sorted, hi, "right")
    P, N = len(anom), len(normal)
    return {"auc_tol": float(pairs.sum()) / max(P * N, 1) + 1e-12,
            "ap_tol": float(np.minimum(1.0, near / r_min).sum()) / max(P, 1)
            + 1e-12,
            "ambiguous_pairs": int(pairs.sum()),
            "anomalies_with_a_neighbour": int((near > 0).sum())}


def phase_creditcard_path(card: str) -> dict:
    """The creditcard job through ``creditcard.run`` on the card at the
    Kaggle file's row count: one fit launch through rows, a prefix held
    against the plain version, the report against a CPU recompute."""
    reset_fit_launches()
    reset_launches()
    out = io.StringIO()
    with _recording(creditcard_cli, "synth_creditcard_csv") as synth, \
            _recording(creditcard_cli, "produce_csv_lines") as produced, \
            _recording(Trainer, "fit_compiled") as fits, \
            _initial_states() as starts, \
            _recording(Trainer, "_to_device") as moved, \
            _recording(anomaly, "reconstruction_errors") as scored, \
            _recording(creditcard_cli, "evaluate_detector") as evals, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        result = creditcard_cli.run([f"synth:{CC_ROWS}"])  # the card
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = path_launches()
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if counts != {**expected_launches(), "fused_fit": 1} or \
            by_design["rows"] != 1:
        raise AssertionError(f"creditcard: launches {counts} ({by_design}), "
                             f"not one fit launch through rows")
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    if printed != json.loads(json.dumps(result)) or \
            result["records"] != CC_ROWS:
        raise AssertionError(f"creditcard printed {printed}")
    history = fits[0].result
    losses = history["loss"]
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"creditcard fit did not converge: {losses}")

    # the launch: its inputs, then the kernel against the plain version
    # from the same state on the first CC_PREFIX_STEPS batches (these
    # launches are comparisons, made after the path's counts were read)
    # fit_compiled moves the stacked batches, then the masks, to the card
    state, epochs = starts[0], fits[0].kw["epochs"]
    xs, masks = moved[0].result, moved[1].result
    S, B, F = xs.shape
    design = fused_train.fit_design(B, F, CREDITCARD_AUTOENCODER.encoding_dim,
                                    CREDITCARD_AUTOENCODER.hidden_dim)
    if (B, F, epochs, design) != (32, 30, 5, "rows"):
        raise AssertionError(f"creditcard fit at B={B}, F={F}, {epochs} "
                             f"epochs, design {design}")
    k = CC_PREFIX_STEPS
    prefix_err = check_fit(
        "creditcard prefix",
        fused_train.fused_fit(state, xs[:k], masks[:k], 1),
        fused_train.fused_fit_reference(state, xs[:k], masks[:k], 1), k)
    kernel_ms = [cuda_ms(lambda: fused_train.fused_fit(state, xs, masks,
                                                        epochs), 1)
                 for _ in range(2)]
    plain_prefix_ms = cuda_ms(lambda: fused_train.fused_fit_reference(
        state, xs[:k], masks[:k], 1), 1)

    # the scores against a CPU recompute, and the report from them
    ev = evals[0]
    _, params, x, labels = ev.args[:4]
    card_scores = scored[0].result
    params_cpu = {key: v.detach().cpu() for key, v in params.items()}
    t0 = time.perf_counter()
    cpu_scores = anomaly.reconstruction_errors(CREDITCARD_AUTOENCODER,
                                               params_cpu, x, device="cpu")
    cpu_s = time.perf_counter() - t0
    score_err = check_close("creditcard scores", torch.from_numpy(card_scores),
                            torch.from_numpy(cpu_scores), **CC_SCORE_TOL)
    want = anomaly.evaluate_detector(None, None, x, labels, threshold=5.0,
                                     scores=cpu_scores)
    report = result["report"]
    tol = ranking_tolerance(cpu_scores, labels, CC_SCORE_TOL["rtol"])
    if abs(report["roc_auc"] - want.roc_auc) > tol["auc_tol"] or \
            abs(report["avg_precision"] - want.avg_precision) > tol["ap_tol"] \
            or report["n"] != CC_ROWS or not report["roc_auc"] > 0.9:
        raise AssertionError(f"creditcard report {report} vs CPU "
                             f"{want.as_dict()} (tolerance {tol})")
    warm = _recording(anomaly, "reconstruction_errors")
    with warm as again:
        anomaly.reconstruction_errors(CREDITCARD_AUTOENCODER, params, x)
    bound = fit_bound(S, B, F, CREDITCARD_AUTOENCODER.encoding_dim,
                      CREDITCARD_AUTOENCODER.hidden_dim, epochs)
    info = {"phase": "creditcard_path", "card": card, "records": CC_ROWS,
            "trained_rows": history["records"][0], "shape": [S, B, F],
            "epochs": epochs, "steps": epochs * S, "design": design,
            "kernel_launches": 1, "kernel_launches_by_design": by_design,
            "losses": losses, "seconds": seconds,
            "csv_seconds": synth[0].seconds,
            "produce_seconds": produced[0].seconds,
            # the training pass of the batcher (poll, CSV decode, scaler,
            # filter, batch), then transfer + kernel + the one sync
            "batching_seconds": history["host_pipeline_s"],
            "fit_seconds": fits[0].seconds,
            "fit_device_seconds": history["device_compute_s"],
            "kernel_ms": kernel_ms,
            "us_per_step": 1e3 * min(kernel_ms) / (epochs * S),
            "plain_ms_prefix": plain_prefix_ms, "prefix_steps": k,
            "plain_ms_per_step": plain_prefix_ms / k,
            "prefix_max_abs_err": prefix_err,
            **{key: bound[key] for key in ("bound_ms", "bound_by",
                                           "one_sm_bound_ms")},
            # the second pass of the batcher and the evaluation
            "eval_seconds": seconds - synth[0].seconds
            - produced[0].seconds - fits[0].seconds,
            "scoring_seconds": scored[0].seconds,
            "report_seconds": evals[0].seconds,
            "reconstruction_errors_rows_per_s": CC_ROWS / scored[0].seconds,
            "reconstruction_errors_warm_rows_per_s":
                CC_ROWS / again[0].seconds,
            "cpu_recompute_seconds": cpu_s,
            "score_max_abs_err": score_err,
            "report": report, "cpu_auc": want.roc_auc,
            "cpu_ap": want.avg_precision, "ranking_tolerance": tol}
    emit(info)
    return {"launches": 1, "launches_by_design": by_design,
            "kernel_ms": min(kernel_ms), "plain_ms_per_step":
                plain_prefix_ms / k, "steps": epochs * S,
            "max_abs_err": prefix_err, "counts": counts, "shape": [S, B, F],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


LSTM_MODEL = "lstm1"
#: the LSTM CLI's take (15 batches of 64 windows) and predict slice
LSTM_TRAIN_STEPS = 15 * 5
LSTM_PAYLOADS = 3 * 64


def _run_lstm(mode: str, root: str, device=None) -> dict:
    argv = [f"emulator:{LIVE_RECORDS}", CLI_TOPIC, "0", "model-predictions",
            mode, LSTM_MODEL, root]
    out = io.StringIO()
    with _recording(cli_app, "_broker_for") as brokers, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = lstm_cli.main(argv, device=device)
        if device is None:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"lstm {mode} returned {rc}:\n{text}")
    stats = [line for line in text.splitlines() if line.startswith("stats: ")]
    return {"seconds": seconds, "broker": brokers[0].result,
            "stats": json.loads(stats[-1][len("stats: "):])}


def _restored(root: str, where: str) -> dict:
    return CheckpointManager.load_dir(ArtifactStore(root).download_tree(
        LSTM_MODEL, str(Path(root) / where)))


def phase_lstm_path(card: str, root: str) -> dict:
    """The LSTM CLI's train then predict on the card, held against the
    same train on the CPU and a CPU recompute of the payloads."""
    card_root, cpu_root = str(Path(root) / "lstm"), str(Path(root) / "lstm_cpu")
    reset_fit_launches()
    reset_launches()
    train = _run_lstm("train", card_root)
    predict = _run_lstm("predict", card_root)
    counts = path_launches()
    if any(counts.values()):
        raise AssertionError(f"the LSTM path launched {counts}")
    cpu_train = _run_lstm("train", cpu_root, device="cpu")
    losses, cpu_losses = train["stats"]["loss"], cpu_train["stats"]["loss"]
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"lstm train did not converge: {losses}")
    err = check_close("lstm losses", torch.tensor(losses),
                      torch.tensor(cpu_losses), **METRIC_TOL)
    card_ckpt = _restored(card_root, "check")
    cpu_ckpt = _restored(cpu_root, "check")
    if card_ckpt["step"] != LSTM_TRAIN_STEPS or \
            card_ckpt["cursors"] != cpu_ckpt["cursors"]:
        raise AssertionError(f"lstm checkpoint step {card_ckpt['step']}, "
                             f"cursors {card_ckpt['cursors']} vs "
                             f"{cpu_ckpt['cursors']}")
    for key, v in card_ckpt["params"].items():
        err = max(err, check_close(f"lstm params {key}", v,
                                   cpu_ckpt["params"][key], **STATE_TOL))

    broker = predict["broker"]
    payloads = [m.value.decode() for m in broker.fetch(
        "model-predictions", 0, 0, broker.end_offset("model-predictions", 0))]
    fresh = cli_app._broker_for(f"emulator:{LIVE_RECORDS}", CLI_TOPIC)
    batches = SensorBatches(StreamConsumer(fresh, [f"{CLI_TOPIC}:0:0"]),
                            batch_size=64, window=1, skip=15, take=3)
    module = LSTMSpec().build("cpu")
    module.load_state_dict(card_ckpt["params"])
    with torch.no_grad():
        want = np.concatenate([module(torch.from_numpy(b.x)).numpy()
                               [:b.n_valid] for b in batches])
    rows = np.array([p.replace("[", " ").replace("]", " ").split()
                     for p in payloads], np.float64)
    if len(payloads) != LSTM_PAYLOADS or rows.shape != (LSTM_PAYLOADS, 18) \
            or not all(p.startswith("[[") for p in payloads) \
            or not np.allclose(rows, want.reshape(len(want), -1),
                               **CLI_TOL_ALL):
        raise AssertionError(f"lstm predict: {len(payloads)} payloads, "
                             f"shape {rows.shape}, vs a CPU recompute")
    info = {"phase": "lstm_path", "card": card,
            "losses": losses, "cpu_losses": cpu_losses,
            "fit_max_abs_err": err, "steps": LSTM_TRAIN_STEPS,
            "train_seconds": train["seconds"],
            "fit_seconds": train["stats"]["fit_seconds"],
            "fit_device_seconds": train["stats"]["device_compute_s"],
            "ms_per_step": 1e3 * train["stats"]["device_compute_s"]
            / LSTM_TRAIN_STEPS,
            "cpu_fit_seconds": cpu_train["stats"]["fit_seconds"],
            "predict_seconds": predict["seconds"],
            "payloads": len(payloads),
            "payload_max_abs_err": float(np.abs(
                rows - want.reshape(len(want), -1)).max()),
            "score_seconds": predict["stats"]["score_seconds"],
            "kernel_launches": counts}
    emit(info)
    return {"counts": counts}


MNIST_N = 60_000
#: classifier steps held against a CPU run from the same init
MNIST_CHECK_STEPS = 50


def phase_mnist_path(card: str) -> dict:
    """The MNIST ingestion smoke through ``mnist_smoke.run`` on the card
    at MNIST's training-set size, and the classifier's first steps held
    against the CPU."""
    reset_fit_launches()
    reset_launches()
    out = io.StringIO()
    with _recording(mnist_cli, "classifier_fit") as fits, \
            _recording(mnist_cli, "produce_mnist") as produced, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        result = mnist_cli.run(["--n", str(MNIST_N)])  # the card
        seconds = time.perf_counter() - t0
    counts = path_launches()
    if any(counts.values()):
        raise AssertionError(f"the MNIST path launched {counts}")
    if not result["ingestion_intact"] or not \
            result["produced"] == result["streamed_records"] == MNIST_N:
        raise AssertionError(f"mnist ingestion: {result}")
    for path in ("streamed", "control"):
        loss = result[path]["loss"]
        if len(loss) != 2 or not all(math.isfinite(v) for v in loss) \
                or not loss[-1] < loss[0]:
            raise AssertionError(f"mnist {path} did not learn: {loss}")
    images, labels = synth_mnist(MNIST_N)
    n = MNIST_CHECK_STEPS * 32
    x, y = images[:n].astype(np.float32), labels[:n]
    card_fit = mnist_cli.classifier_fit(MNISTClassifier(), x, y, 32, 1)
    cpu_fit = mnist_cli.classifier_fit(MNISTClassifier(device="cpu"), x, y,
                                       32, 1)
    err = max(check_close("mnist loss", torch.tensor(card_fit["loss"]),
                          torch.tensor(cpu_fit["loss"]), rtol=1e-4, atol=0.0),
              check_close("mnist accuracy", torch.tensor(card_fit["accuracy"]),
                          torch.tensor(cpu_fit["accuracy"]), rtol=1e-4,
                          atol=0.0))
    for key, v in card_fit["params"].items():
        err = max(err, check_close(f"mnist params {key}", v,
                                   cpu_fit["params"][key], **STATE_TOL))
    steps = 2 * (MNIST_N // 32)
    info = {"phase": "mnist_path", "card": card, "n": MNIST_N,
            "ingestion_intact": True, "streamed": result["streamed"],
            "control": result["control"], "seconds": seconds,
            "produce_seconds": produced[0].seconds,
            "fit_seconds": {"streamed": fits[0].seconds,
                            "control": fits[1].seconds},
            "ms_per_step": {"streamed": 1e3 * fits[0].seconds / steps,
                            "control": 1e3 * fits[1].seconds / steps},
            "ingest_seconds": seconds - fits[0].seconds
            - fits[1].seconds,
            "check_steps": MNIST_CHECK_STEPS, "check_max_abs_err": err,
            "kernel_launches": counts}
    emit(info)
    return {"counts": counts}


def fit_bound(S: int, B: int, F: int, E: int, H: int, epochs: int) -> dict:
    """Least time for the fit on an H100: the larger of fp32 work over
    the fp32 peak and bytes (slice + state in, state + history out) over
    the memory rate; and the one-SM bound, the same flops over one SM's
    share of the fp32 peak (the fit is a chain of dependent steps that one
    block runs)."""
    n = E * F + E + H * E + H + H * H + H + F * H + F
    macs = E * F + H * E + H * H + F * H  # one forward
    # forward + weight grads (2 × macs) + the delta chain (no dW1 input
    # delta), 2 flops each; Adam ~10 flops per parameter
    step_flops = 2 * B * (2 * macs + F * H + H * H + H * E) + 10 * n
    flops = epochs * S * step_flops
    bytes_moved = 4 * (S * B * F + S * B + 3 * n) + 4 * (3 * n + 2 * epochs)
    ops_ms, bytes_ms = 1e3 * flops / FP32_FLOPS, 1e3 * bytes_moved / HBM_BYTES_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "one_sm_bound_ms": 1e3 * flops / (FP32_FLOPS / SMS),
            "bound_flops": flops, "bound_bytes": bytes_moved}


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fit_in_turns(tag: str, xs, masks, epochs: int):
    """Both fit designs on one slice: each held against the plain version
    over the whole fit (every epoch and the final state: a fault that
    shows only late in a long fit fails here), then timed in turns, the
    design ``fit_design`` picks first (it, the other, the other, it).
    Returns (that design, ms per fit by design, largest difference by
    design, the plain version's output and the kernels')."""
    S, B, F = xs.shape
    state = fresh_state(CAR_AUTOENCODER, "cuda")
    picked = fused_train.fit_design(B, F, CAR_AUTOENCODER.encoding_dim,
                                    CAR_AUTOENCODER.hidden_dim)
    designs = (picked,) + tuple(d for d in fused_train.DESIGNS
                                if d != picked)

    def kernel(design):
        return fused_train.fused_fit(state, xs, masks, epochs, design=design)

    kernel_out = {d: kernel(d) for d in designs}  # warm, and held below
    plain_out = fused_train.fused_fit_reference(state, xs, masks, epochs)
    torch.cuda.synchronize()
    errs = {d: check_fit(f"{tag} {d}", out, plain_out, epochs * S)
            for d, out in kernel_out.items()}
    ms = {d: [] for d in designs}
    for d in designs + designs[::-1]:
        ms[d].append(cuda_ms(lambda: kernel(d), 5))
    return picked, ms, errs, plain_out, kernel_out


def _stacked(batches):
    bs = list(next(batches.epochs(1)))
    return (torch.from_numpy(np.stack([b.x for b in bs])).cuda(),
            torch.from_numpy(np.stack([b.mask for b in bs])).cuda())


def phase_timing(card: str, batches, source) -> dict:
    xs, masks = _stacked(batches)
    S, B, F = xs.shape
    epochs = 20
    state = fresh_state(CAR_AUTOENCODER, "cuda")
    main_design, ms, errs, plain_out, kernel_out = fit_in_turns(
        "reference shape", xs, masks, epochs)

    def plain():
        return fused_train.fused_fit_reference(state, xs, masks, epochs)

    model = CAR_AUTOENCODER.build("cuda")
    loop = make_scanned_fit(model, Adam())

    def step_loop():
        return loop(state, xs, xs, masks, epochs)

    loop(state, xs[:2], xs[:2], masks[:2], 1)
    plain_ms = cuda_ms(plain, 2)
    loop_ms = cuda_ms(step_loop, 1)
    E, H = CAR_AUTOENCODER.encoding_dim, CAR_AUTOENCODER.hidden_dim
    p_loss = plain_out[1]
    rel = {d: float(((out[1] - p_loss).abs() / p_loss.abs()).max())
           for d, out in kernel_out.items()}

    # the rows design's largest batch, on the same fleet slice
    wide = SensorBatches(source, batch_size=256, take=39, only_normal=True)
    w_xs, w_masks = _stacked(wide)
    w_S, w_B, _ = w_xs.shape
    w_design, w_ms, w_errs, _, _ = fit_in_turns("B=256", w_xs, w_masks,
                                               epochs)
    w_bound = fit_bound(w_S, w_B, F, E, H, epochs)
    info = {"phase": "timing", "card": card, "shape": [S, B, F],
            "epochs": epochs, "steps": epochs * S, "design": main_design,
            "kernel_ms": ms,
            "us_per_step": {d: 1e3 * min(t) / (epochs * S)
                            for d, t in ms.items()},
            "plain_ms": plain_ms, "step_loop_ms": loop_ms,
            **fit_bound(S, B, F, E, H, epochs),
            "max_abs_err": errs, "loss_rel_diff_max": rel,
            "batch_256": {
                "shape": [w_S, w_B, F], "steps": epochs * w_S,
                "design": w_design, "kernel_ms": w_ms,
                "us_per_step": {d: 1e3 * min(t) / (epochs * w_S)
                                for d, t in w_ms.items()},
                "bound_ms": w_bound["bound_ms"],
                "one_sm_bound_ms": w_bound["one_sm_bound_ms"],
                "max_abs_err": w_errs}}
    emit(info)
    return info


def _qkv(B, T, H, D, dtype, seed, grid=False):
    """Three seeded normal [B, T, H, D] tensors on the card.  ``grid``
    rounds them to multiples of 1/4 (GRID_NOTE)."""
    rng = np.random.default_rng(seed)
    ts = [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3)]
    if grid:
        ts = [np.round(t * 4) / 4 for t in ts]
    return [torch.from_numpy(t).to("cuda", dtype) for t in ts]


#: The bf16 backward's grid cases.  Kernel and plain version sum Q·Kᵀ and
#: dO·Vᵀ in f32 in different orders, so off the grid a p or ds can round
#: to the other bf16 neighbour in one of them (a flip, which
#: ``bwd_rounding_flips`` must explain).  On a 1/4 grid every product is
#: a multiple of 1/16 and those sums (128 terms, well under 2^24
#: sixteenths) are exact in any order: both round the same p and ds, so
#: these cases allow no flip at all.
GRID_NOTE = "inputs on a 1/4 grid: Q·Kᵀ and dO·Vᵀ exact in f32, no flip"


def check_attention(tag, out, want, design, block) -> dict:
    """Kernel (o, lse) against the plain version's at ``block``: the
    ``wgmma`` design by ``check_wgmma_forward`` (which must also fail O
    scaled by 0.9, whole or in its last row), the FMA design at ATTN_TOL;
    returns the largest absolute difference of each: {"o": .., "lse": ..}
    (and the ``wgmma`` design's "o_row_rel")."""
    (o, lse), (want_o, want_lse) = out, want
    if design == "wgmma":
        err = check_wgmma_forward(tag, o, lse, want_o, want_lse, block)
        check_rejects_scaled_o(tag, o, lse, want_o, want_lse, block)
        return err
    o_tol, lse_tol = ATTN_TOL[want_o.dtype]
    return {"o": check_close(f"{tag} O", o, want_o, **o_tol),
            "lse": check_close(f"{tag} LSE", lse, want_lse, **lse_tol)}


ATTN_CASES = [  # dtype, B, T, H, D, causal, block
    (torch.float32, 2, 40, 2, 8, True, 16),
    (torch.float32, 2, 32, 2, 8, False, 16),
    (torch.float32, 2, 4096, 4, 16, True, 128),
    (torch.bfloat16, 1, 1000, 2, 128, True, 128),
    (torch.bfloat16, 1, 1024, 2, 128, False, 128),
]


#: the tensor-core forward's cases (bf16, D=128; the plain version at the
#: kernel's 64-row key tile, or at the caller's block 16 where T = 1,040
#: leaves a ragged key tile): dtype, B, T, H, D, causal, block
WGMMA_FWD_CASES = [
    *[(torch.bfloat16, B, T, H, 128, True, 64)
      for T in (1, 63, 64, 65, 127, 128, 129, 1000, 4096)
      for B, H in ((1, 1), (2, 3))],
    (torch.bfloat16, 2, 64, 3, 128, False, 64),
    (torch.bfloat16, 2, 1024, 3, 128, False, 64),
    (torch.bfloat16, 2, 1040, 3, 128, False, 16),
]


#: the split-TF32 forward's cases (f32, D=8 and 16; the plain version at
#: blocks 128 when causal, at the whole T when not, which a non-causal call
#: needs to divide T): dtype, B, T, H, D, causal, block
MMA_FWD_CASES = [(torch.float32, B, T, H, D, causal, 128 if causal else T)
                 for D in (8, 16) for causal in (True, False)
                 for T in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000,
                           4096)
                 for B, H in ((1, 1), (2, 3))]


def phase_attention_kernel() -> dict:
    errs = {"causal": 0.0, "full": 0.0}
    wgmma_errs = {"o": 0.0, "o_row_rel": 0.0, "lse": 0.0}
    mma_errs = {"o": 0.0, "lse": 0.0}
    cases = []
    for (dtype, B, T, H, D, causal, block), meant in (
            [(case, None) for case in ATTN_CASES]
            + [(case, "mma_tf32x3") for case in MMA_FWD_CASES]
            + [(case, "wgmma") for case in WGMMA_FWD_CASES]):
        q, k, v = _qkv(B, T, H, D, dtype, seed=T + D)
        entry = "causal" if causal else "full"
        design = flash_design(dtype, D, "forward")
        tag = f"{str(dtype)[6:]} B={B} T={T} H={H} D={D} {entry} {design}"
        if meant and design != meant:
            raise AssertionError(f"{tag}: a case of the {meant} design")
        before = flash_attention.launches[entry]
        out = flash_attention_fwd(q, k, v, causal, block, block)
        torch.cuda.synchronize()
        if flash_attention.launches[entry] != before + 1:
            raise AssertionError(f"{tag}: the {entry} kernel was not launched")
        want = flash_attention_reference(q, k, v, causal, block, block)
        err = check_attention(tag, out, want, design, block)
        again = flash_attention_fwd(q, k, v, causal, block, block)
        if not (torch.equal(again[0], out[0])
                and torch.equal(again[1], out[1])):
            raise AssertionError(f"{tag}: two launches differ")
        errs[entry] = max(errs[entry], err["o"], err["lse"])
        if design == "wgmma":
            wgmma_errs = {key: max(wgmma_errs[key], err[key])
                          for key in wgmma_errs}
        elif design == "mma_tf32x3":
            mma_errs = {key: max(mma_errs[key], err[key])
                        for key in mma_errs}
        cases.append({"case": tag, "block": block, "max_abs_err": err})
    q, k, v = _qkv(1, 40, 2, 8, torch.float32, seed=0)
    before = dict(flash_attention.launches)
    try:
        flash_attention_fwd(q, k, v, False, 16, 16)
    except ValueError:
        pass
    else:
        raise AssertionError("non-causal T=40 with block 16 did not raise")
    if flash_attention.launches != before:
        raise AssertionError("a refused call counted a launch")
    emit({"phase": "attention_kernel", "cases": cases,
          "wgmma_max_abs_err": wgmma_errs,
          "mma_tf32x3_cases": len(MMA_FWD_CASES),
          "mma_tf32x3_max_abs_err": mma_errs,
          "tolerance": {"f32": "O, LSE rtol=atol=2e-5",
                        "bf16 fma": "O rtol=atol=2e-2 in f32, LSE atol 1e-3",
                        "bf16 wgmma": "each O row's error within 1e-2 of "
                                      "its norm; O rtol 2e-2 atol 1e-3 in "
                                      "f32 at blocks 64 (rtol=atol=2e-2 at "
                                      "other blocks); LSE atol 1e-3; O x "
                                      "0.9 (whole, or its last row) fails"},
          "bit_repeat": True, "ragged_non_causal_raises": True})
    return errs


def reset_launches() -> None:
    for key in flash_attention.launches:
        flash_attention.launches[key] = 0


def reset_fit_launches() -> None:
    fused_train.fused_fit.launches = 0
    fused_train.fused_fit.launches_by_design = dict.fromkeys(
        fused_train.DESIGNS, 0)


def path_launches() -> dict:
    """Every kernel's launch count, as the wrappers count them."""
    return {"fused_fit": fused_train.fused_fit.launches,
            **flash_attention.launches}


def expected_launches(**counts) -> dict:
    """Every flash entry point at 0 but those named."""
    return {key: counts.get(key, 0) for key in flash_attention.launches}


def fleet_histories(num_cars: int, ticks: int) -> np.ndarray:
    """[num_cars, ticks, 18] normalized per-car sensor histories: the
    fleet stepped ``ticks`` times, each tick's rows stacked per car."""
    gen = FleetGenerator(FleetScenario(num_cars=num_cars, failure_rate=0.01))
    rows = np.stack([gen.sensor_matrix(gen.step_columns())
                     for _ in range(ticks)], axis=1)
    return CAR_NORMALIZER.np(rows)


#: the serving path's fleet: cars, and ticks of history per car
SF_CARS, SF_TICKS = 100, 4096


def phase_sensorformer_path(card: str) -> dict:
    t0 = time.perf_counter()
    hist = fleet_histories(SF_CARS, SF_TICKS)
    data_s = time.perf_counter() - t0
    model = SensorFormer(attn_mode="flash").eval()  # no device: the card
    x = torch.from_numpy(hist).to(model.head.weight.device)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        pred = model(x)
        scores = SensorFormer.anomaly_scores(pred, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(flash_attention.launches)
    if launches != expected_launches(causal=model.num_layers):
        raise AssertionError(f"one forward launched {launches}, not "
                             f"{model.num_layers} causal")
    if tuple(scores.shape) != (SF_CARS, SF_TICKS - 1) \
            or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"scores {tuple(scores.shape)}, finite "
                             f"{bool(torch.isfinite(scores).all())}")

    def same_weights(mode):
        m = SensorFormer(attn_mode=mode).eval()
        m.load_state_dict(model.state_dict())
        return m

    with torch.no_grad():
        plain_scores = SensorFormer.anomaly_scores(
            same_weights("flash_reference")(x), x)
        err = check_close("scores vs plain version", scores, plain_scores,
                          **MODEL_TOL)
        dense_scores = SensorFormer.anomaly_scores(
            same_weights("dense")(x[:4]), x[:4])
        dense_err = check_close("scores vs dense (4 cars)", scores[:4],
                                dense_scores, **MODEL_TOL)

        def forward():
            return SensorFormer.anomaly_scores(model(x), x)

        ms = cuda_ms(forward, 5)
    steps = SF_CARS * (SF_TICKS - 1)
    info = {"phase": "sensorformer_path", "card": card,
            "shape": list(x.shape), "d_model": model.d_model,
            "num_heads": model.num_heads, "num_layers": model.num_layers,
            "data_seconds": data_s, "first_forward_seconds": first_s,
            "kernel_launches": launches, "max_abs_err_vs_plain": err,
            "max_abs_err_vs_dense_4_cars": dense_err,
            "score_mean": float(scores.mean()), "forward_ms": ms,
            "scored_steps_per_s": steps / (ms / 1e3)}
    emit(info)
    return {**info, "histories": hist}


def attention_bound(B, T, H, D, causal, dtype, flops_per_pair_per_d=4,
                    tensors=4, row_bytes=4) -> dict:
    """Least time for one attention call on an H100: its flops per live
    (query, key) pair (``flops_per_pair_per_d``·D) on the tensor cores,
    against the bytes it must move: ``tensors`` [B, T, H, D] tensors and
    ``row_bytes`` of f32 per row, each read or written once.  bf16 runs at
    the bf16 peak; float32 as split TF32, three tf32 products a product,
    at the TF32 peak.  Beside it, not in it: the same flops at the fp32
    FMA rate (``fp32_fma_floor_ms``) and one ex2 per live pair
    (``ex2_floor_ms``).  The forward is 4·D flops, q, k, v, o and the lse
    (the defaults)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = flops_per_pair_per_d * D * pairs * B * H
    elt = torch.tensor([], dtype=dtype).element_size()
    bytes_moved = tensors * B * H * T * D * elt + row_bytes * B * H * T
    if dtype == torch.float32:
        ops_ms = 1e3 * TF32_TERMS * flops / TF32_FLOPS
    else:
        ops_ms = 1e3 * flops / BF16_FLOPS
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_flops": flops, "bound_bytes": bytes_moved,
            "fp32_fma_floor_ms": 1e3 * flops / FP32_FLOPS,
            "ex2_floor_ms": 1e3 * pairs * B * H / EX2_PER_S}


TIMING_SHAPES = {  # name: (dtype, B, T, H, D, plain block, reps)
    "sensorformer_layer": (torch.float32, 100, 4096, 4, 16, 128, 5),
    "long_context": (torch.bfloat16, 1, 65536, 2, 128, 1024, 3),
}


def phase_attention_timing(card: str) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    out = {}
    for shape, (dtype, B, T, H, D, block, reps) in TIMING_SHAPES.items():
        q, k, v = _qkv(B, T, H, D, dtype, seed=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        for causal in (True, False):
            entry = "causal" if causal else "full"

            def kernel():
                return flash_attention_fwd(q, k, v, causal, block, block)

            def plain():
                return flash_attention_reference(q, k, v, causal, block,
                                                 block)

            def library():
                # the yardstick only; never the math fallback, which
                # would hold the whole [B, H, T, T] score matrix
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                  SDPBackend.EFFICIENT_ATTENTION,
                                  SDPBackend.CUDNN_ATTENTION]):
                    return scaled_dot_product_attention(qh, kh, vh,
                                                        is_causal=causal)

            design = flash_design(dtype, D, "forward")
            err = check_attention(f"{shape} {entry}", kernel(), plain(),
                                  design, block)
            library()
            torch.cuda.synchronize()
            ms = cuda_ms(kernel, reps)
            plain_ms = cuda_ms(plain, 2)
            library_ms = cuda_ms(library, reps)
            ms_again = cuda_ms(kernel, reps)
            bound = attention_bound(B, T, H, D, causal, dtype)
            out[(shape, entry)] = info = {
                "phase": "attention_timing", "card": card, "shape": shape,
                "entry": entry, "dtype": str(dtype)[6:],
                "B": B, "T": T, "H": H, "D": D, "plain_block": block,
                "design": design,
                "kernel_ms": [ms, ms_again], "plain_ms": plain_ms,
                "library_ms": library_ms,
                "max_abs_err": max(err["o"], err["lse"]),
                "max_abs_err_by_output": err, **bound,
                "tflops": bound["bound_flops"] / (min(ms, ms_again) / 1e3)
                / 1e12}
            emit(info)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return out

#: the backward's parts: flops per live pair (× D), [B, T, H, D] tensors
#: moved, f32 bytes per row.  Both kernels recompute Q·Kᵀ and dO·Vᵀ (2·D
#: each); dK/dV adds Pᵀ·dO and dSᵀ·Q, dQ adds dS·K.  The whole backward
#: counts each product once: 10·D; it reads q, k, v, o, dO and the lse and
#: writes dq, dk, dv (delta is derived from o and dO).  dK/dV reads q, k,
#: v, dO, lse and delta and writes dk, dv; dQ writes dq.
BWD_PARTS = {"backward": (10, 8, 4), "dkv": (8, 6, 8), "dq": (6, 5, 8)}


def check_grads(tag, got, want, dtype, inputs=None, causal=True,
                grid=False) -> tuple:
    """Kernel (dq, dk, dv) against the plain backward's at the dtype's
    bound; bf16 rows outside it must each be one rounding flip of a p or
    ds of ``inputs`` (q, k, v, o, lse, do), none on ``grid`` inputs.
    Returns the largest absolute difference of each kernel's outputs,
    {"dkv": .., "dq": ..}, and the flips, each tagged with the case."""
    flips = []
    if dtype == torch.bfloat16:
        try:
            flips = bwd_rounding_flips(*inputs, got, want, causal,
                                       max_rows=0 if grid else None,
                                       **GRAD_TOL[dtype])
        except AssertionError as exc:
            raise AssertionError(f"{tag}: {exc}") from None
        errs = {name: float((g.double() - w.double()).abs().max())
                for name, g, w in zip("qkv", got, want)}
    else:
        errs = {name: check_close(f"{tag} d{name}", g.float(), w.float(),
                                  **GRAD_TOL[dtype])
                for name, g, w in zip("qkv", got, want)}
    return ({"dkv": max(errs["k"], errs["v"]), "dq": errs["q"]},
            [{"case": tag, **flip} for flip in flips])


#: the tensor-core design's cases (bf16, D=128; the plain version at the
#: kernels' 64-row tiles): dtype, B, T, H, D, causal, block
WGMMA_BWD_CASES = [
    *[(torch.bfloat16, B, T, H, 128, True, 64)
      for T in (1, 63, 64, 65, 1000, 4096) for B, H in ((1, 1), (2, 3))],
    (torch.bfloat16, 2, 64, 3, 128, False, 64),
    (torch.bfloat16, 2, 1024, 3, 128, False, 64),
    (torch.bfloat16, 2, 4096, 2, 128, True, 64),
]
#: the longer of those cases again on grid inputs (GRID_NOTE)
WGMMA_BWD_GRID_CASES = [case for case in WGMMA_BWD_CASES if case[2] >= 1000]
#: the split-TF32 design's cases (f32, D=8 and 16; the plain version at
#: blocks 128 when causal, at the whole T when not, which a non-causal
#: call needs to divide T): dtype, B, T, H, D, causal, block
MMA_BWD_CASES = [(torch.float32, B, T, H, D, causal, 128 if causal else T)
                 for D in (8, 16) for causal in (True, False)
                 for T in (1, 15, 16, 17, 63, 64, 65, 1000, 4096)
                 for B, H in ((1, 1), (2, 3))]


def phase_attention_backward_kernel() -> dict:
    errs = {}
    cases, flips = [], []
    for (dtype, B, T, H, D, causal, block), grid, meant in (
            [(case, False, None) for case in ATTN_CASES]
            + [(case, False, "mma_tf32x3") for case in MMA_BWD_CASES]
            + [(case, False, "wgmma") for case in WGMMA_BWD_CASES]
            + [(case, True, "wgmma") for case in WGMMA_BWD_GRID_CASES]):
        q, k, v = _qkv(B, T, H, D, dtype, seed=T + D, grid=grid)
        do = _qkv(B, T, H, D, dtype, seed=T + D + 1, grid=grid)[0]
        entry = "causal" if causal else "full"
        design = flash_design(dtype, D, "backward")
        tag = (f"backward {str(dtype)[6:]} B={B} T={T} H={H} D={D} {entry} "
               f"{design}{' grid' if grid else ''}")
        if meant and design != meant:
            raise AssertionError(f"{tag}: a case of the {meant} design")
        o, lse = flash_attention_fwd(q, k, v, causal, block, block)
        before = dict(flash_attention.launches)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal, block, block)
        torch.cuda.synchronize()
        for kind in ("dkv", "dq"):
            key = f"bwd_{kind}_{entry}"
            if flash_attention.launches[key] != before[key] + 1:
                raise AssertionError(f"{tag}: the {key} kernel was not "
                                     f"launched")
        want = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal, block, block)
        err, case_flips = check_grads(tag, got, want, dtype,
                                      (q, k, v, o, lse, do), causal, grid)
        flips += case_flips
        case = {"case": tag, "block": block, "max_abs_err": err,
                "grid_inputs": grid, "rounding_flips": len(case_flips)}
        if dtype == torch.float32 and D == 8:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            dense = torch.autograd.grad(
                attention_reference(*leaves, causal=causal), leaves, do)
            case["max_abs_err_vs_dense_autograd"] = check_grads(
                f"{tag} vs dense autograd", got, dense, dtype)[0]
        again = flash_attention_bwd(q, k, v, o, lse, do, causal, block,
                                    block)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"{tag}: two launches differ")
        for kind in ("dkv", "dq"):
            errs[(kind, entry)] = max(errs.get((kind, entry), 0.0),
                                      err[kind])
        cases.append(case)
    # only dk is needed: the dK/dV kernel runs, the dQ kernel does not, and
    # dk is the last case's
    before = dict(flash_attention.launches)
    only_k = flash_attention_bwd(q, k, v, o, lse, do, causal, block, block,
                                 needs=(False, True, False))
    ran = {key: flash_attention.launches[key] - before[key]
           for key in before}
    if ran != expected_launches(bwd_dkv_causal=1) or only_k[0] is not None \
            or only_k[2] is not None or not torch.equal(only_k[1], got[1]):
        raise AssertionError(f"{tag}, only dk needed: launched {ran}")
    q, k, v = _qkv(1, 40, 2, 8, torch.float32, seed=0)
    lse = torch.zeros((1, 2, 40), device="cuda")
    before = dict(flash_attention.launches)
    try:
        flash_attention_bwd(q, k, v, q, lse, q, False, 16, 16)
    except ValueError:
        pass
    else:
        raise AssertionError("non-causal backward at T=40 with block 16 "
                             "did not raise")
    if flash_attention.launches != before:
        raise AssertionError("a refused backward counted a launch")
    emit({"phase": "attention_backward_kernel", "cases": cases,
          "rounding_flips": flips,
          "tolerance": {"f32": "dq, dk, dv rtol 1e-4 atol 1e-5",
                        "bf16": "dq, dk, dv rtol 1e-2 atol 1e-3 in f32; a "
                                "row outside it only as one p or ds "
                                "rounding flip (at most 1 row in 10,000, "
                                "at least 2, an output); " + GRID_NOTE},
          "bit_repeat": True, "only_dk_skips_dq": True,
          "ragged_non_causal_raises": True})
    return errs


#: SensorFormer training on the fleet histories: Adam steps after one
#: warm-up step, and cars per chunk of the plain version's gradient
TRAIN_TIMED_STEPS = 5
PLAIN_GRAD_CARS = 10


def phase_sensorformer_train(card: str, hist: np.ndarray) -> dict:
    model = SensorFormer(attn_mode="flash")  # no device: the card
    init, step, put_x = make_sp_train_step(model, Adam(1e-3))
    x = put_x(hist)
    n_cars, T = x.shape[:2]
    L = model.num_layers
    state = init()

    # step 1's loss and grads — what the step computes — held against the
    # plain versions on all cars (autograd through the plain forward, in
    # chunks of cars weighted by their share of the mean) and against
    # dense attention on 4 cars
    loss_k, grads_k = loss_and_grads(model, state.params, x)
    plain = SensorFormer(attn_mode="flash_reference")
    loss_p, grads_p = 0.0, {key: torch.zeros_like(g)
                            for key, g in grads_k.items()}
    for c in range(0, n_cars, PLAIN_GRAD_CARS):
        share = min(PLAIN_GRAD_CARS, n_cars - c) / n_cars
        loss_c, grads_c = loss_and_grads(plain, state.params,
                                         x[c:c + PLAIN_GRAD_CARS])
        loss_p = loss_p + share * loss_c
        for key in grads_p:
            grads_p[key] += share * grads_c[key]
    err_loss = check_close("step-1 loss vs plain", loss_k, loss_p,
                           **TRAIN_LOSS_TOL)
    err_plain = max(check_close(f"grad {key} vs plain", grads_k[key],
                                grads_p[key], **TRAIN_GRAD_TOL)
                    for key in grads_k)
    loss_k4, grads_k4 = loss_and_grads(model, state.params, x[:4])
    loss_d4, grads_d4 = loss_and_grads(SensorFormer(attn_mode="dense"),
                                       state.params, x[:4])
    err_loss_dense = check_close("4-car loss vs dense", loss_k4, loss_d4,
                                 **TRAIN_LOSS_TOL)
    err_dense = max(check_close(f"grad {key} vs dense (4 cars)",
                                grads_k4[key], grads_d4[key],
                                **TRAIN_GRAD_TOL)
                    for key in grads_k4)
    grad_scale = max(float(g.abs().max()) for g in grads_k.values())
    del grads_k, grads_p, grads_c, grads_k4, grads_d4, plain
    torch.cuda.empty_cache()

    # the main path: make_sp_train_step's steps
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    per_step = expected_launches(causal=L, bwd_dkv_causal=L,
                                 bwd_dq_causal=L)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses = []
    for i in range(1 + TRAIN_TIMED_STEPS):
        if i == 1:
            start.record()
        before = dict(flash_attention.launches)
        state, metrics = step(state, x)
        ran = {key: flash_attention.launches[key] - before[key]
               for key in before}
        if ran != per_step:
            raise AssertionError(f"step {i + 1} launched {ran}, not "
                                 f"{per_step}")
        losses.append(metrics["loss"])
    end.record()
    end.synchronize()
    launches = dict(flash_attention.launches)
    step_ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().tolist()
    check_close("step-1 loss vs loss_and_grads", torch.tensor(losses[0]),
                loss_k, rtol=1e-6, atol=0.0)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not converge: {losses}")
    if state.step != 1 + TRAIN_TIMED_STEPS:
        raise AssertionError(f"state at step {state.step}")
    steps = n_cars * (T - 1)
    info = {"phase": "sensorformer_train", "card": card,
            "shape": list(x.shape), "d_model": model.d_model,
            "num_heads": model.num_heads, "num_layers": L,
            "learning_rate": 1e-3, "steps": 1 + TRAIN_TIMED_STEPS,
            "kernel_launches": launches, "losses": losses,
            "step1_loss_err_vs_plain": err_loss,
            "step1_grad_max_abs_err_vs_plain": err_plain,
            "step1_loss_err_vs_dense_4_cars": err_loss_dense,
            "step1_grad_max_abs_err_vs_dense_4_cars": err_dense,
            "step1_grad_max_abs": grad_scale,
            "tolerance": {"loss": TRAIN_LOSS_TOL, "grads": TRAIN_GRAD_TOL},
            "step_ms": step_ms, "trained_steps_per_s": steps / (step_ms / 1e3),
            "peak_memory_bytes": peak}
    emit(info)
    return info


def phase_attention_backward_timing(card: str) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    # the yardstick only; never the math fallback, which would hold the
    # whole [B, H, T, T] score matrix
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    out = {}
    for shape, (dtype, B, T, H, D, block, reps) in TIMING_SHAPES.items():
        q, k, v = _qkv(B, T, H, D, dtype, seed=1)
        do = _qkv(B, T, H, D, dtype, seed=2)[0]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v)]
        do_h = do.transpose(1, 2).contiguous()
        for causal in (True, False):
            entry = "causal" if causal else "full"
            o, lse = flash_attention_fwd(q, k, v, causal, block, block)
            folded = flash_bwd_inputs(q, k, v, o, lse, do)

            def dkv():
                return flash_bwd_dkv(*folded, causal=causal)

            def dq():
                return flash_bwd_dq(*folded, causal=causal)

            def plain():
                return flash_attention_backward_reference(
                    q, k, v, o, lse, do, causal, block, block)

            def port():
                return torch.autograd.grad(
                    flash_attention(*leaves, causal, block, block), leaves,
                    do)

            def lib_forward():
                with sdpa_kernel(backends):
                    return scaled_dot_product_attention(*lib_leaves,
                                                        is_causal=causal)

            def library():
                return torch.autograd.grad(lib_forward(), lib_leaves, do_h)

            lib_out = lib_forward()

            def lib_bwd(which):
                return lambda: torch.autograd.grad(
                    lib_out, [lib_leaves[i] for i in which], do_h,
                    retain_graph=True)

            kernel_grads = flash_attention_bwd(q, k, v, o, lse, do, causal,
                                               block, block)
            err, flips = check_grads(f"{shape} {entry} backward",
                                     kernel_grads, plain(), dtype,
                                     (q, k, v, o, lse, do), causal)
            # the path as a caller runs it, counted alone: one forward, one
            # dK/dV and one dQ launch, and the grads of the kernels above
            reset_launches()
            path_grads = port()
            torch.cuda.synchronize()
            path_launches = dict(flash_attention.launches)
            want_launches = expected_launches(
                **{entry: 1, f"bwd_dkv_{entry}": 1, f"bwd_dq_{entry}": 1})
            if path_launches != want_launches:
                raise AssertionError(f"{shape} {entry} forward + backward "
                                     f"launched {path_launches}")
            if not all(torch.equal(a, b)
                       for a, b in zip(path_grads, kernel_grads)):
                raise AssertionError(f"{shape} {entry}: the path's grads "
                                     f"differ from the kernels'")
            for fn in (dkv, dq, port, library):
                fn()
            torch.cuda.synchronize()
            dkv_ms, dq_ms = cuda_ms(dkv, reps), cuda_ms(dq, reps)
            plain_ms = cuda_ms(plain, 2)
            port_ms = cuda_ms(port, reps)
            library_ms = cuda_ms(library, reps)
            lib_ms = {part: cuda_ms(lib_bwd(which), reps) for part, which in
                      (("backward", (0, 1, 2)), ("dkv", (1, 2)),
                       ("dq", (0,)))}
            dkv_again, dq_again = cuda_ms(dkv, reps), cuda_ms(dq, reps)
            parts = {part: attention_bound(B, T, H, D, causal, dtype, *spec)
                     for part, spec in BWD_PARTS.items()}
            design = flash_design(dtype, D, "backward")

            def kernel_line(kind, times):
                return {"design": design, "ms": times,
                        "library_ms": lib_ms[kind], **parts[kind],
                        "tflops": parts[kind]["bound_flops"]
                        / (min(times) / 1e3) / 1e12}

            out[(shape, entry)] = info = {
                "phase": "attention_backward_timing", "card": card,
                "shape": shape, "entry": entry, "dtype": str(dtype)[6:],
                "B": B, "T": T, "H": H, "D": D, "plain_block": block,
                "dkv": kernel_line("dkv", [dkv_ms, dkv_again]),
                "dq": kernel_line("dq", [dq_ms, dq_again]),
                "backward": {"kernels_ms": min(dkv_ms, dkv_again)
                             + min(dq_ms, dq_again),
                             "plain_ms": plain_ms,
                             "library_ms": lib_ms["backward"],
                             **parts["backward"]},
                # tokens (B·T) over forward + backward seconds: at B=1,
                # bench.py's flash_attention_fwd_bwd_tokens_per_sec
                "forward_backward": {
                    "forward_design": flash_design(dtype, D, "forward"),
                    "kernel_launches": path_launches,
                    "port_ms": port_ms, "library_ms": library_ms,
                    "flash_attention_fwd_bwd_tokens_per_sec":
                        B * T / (port_ms / 1e3),
                    "library_tokens_per_sec": B * T / (library_ms / 1e3)},
                "max_abs_err": err, "rounding_flips": flips}
            emit(info)
            del lib_out, o, lse, folded, kernel_grads, path_grads
        del q, k, v, do, leaves, lib_leaves, do_h
        torch.cuda.empty_cache()
    return out


def launch_counts(key, paths) -> dict:
    """An entry's launches on each path that runs it, read there with
    every count set to 0 just before, and their sum."""
    by_path = {name: counts[key] for name, counts in paths.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def attention_entry(name, replaces, entry, paths, err, timing) -> dict:
    layer = timing[("sensorformer_layer", entry)]
    long = timing[("long_context", entry)]
    return {
        "name": name, "route": "cuda",
        "source": "iotml_torch/ops/csrc/flash_attention.cu",
        "replaces": replaces, "design": layer["design"],
        **launch_counts(entry, paths),
        "max_abs_err": max(err[entry], layer["max_abs_err"],
                           long["max_abs_err"]),
        "ms": min(layer["kernel_ms"]), "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "library_ms": layer["library_ms"],
        "long_context": {"design": long["design"],
                         "ms": min(long["kernel_ms"]),
                         "tflops": long["tflops"],
                         "plain_ms": long["plain_ms"],
                         "bound_ms": long["bound_ms"],
                         "bound_by": long["bound_by"],
                         "library_ms": long["library_ms"]}}


def backward_entry(name, replaces, kind, entry, paths, errs,
                   timing) -> dict:
    """A backward kernel's line: design, ms, bound and library call of
    its own part at the layer call and the long-context call; plain_ms is
    the whole plain backward (no plain version computes one kernel's
    share alone)."""
    layer = timing[("sensorformer_layer", entry)]
    long = timing[("long_context", entry)]
    return {
        "name": name, "route": "cuda",
        "source": "iotml_torch/ops/csrc/flash_attention_bwd.cu",
        "design": layer[kind]["design"],
        "replaces": replaces, **launch_counts(f"bwd_{kind}_{entry}", paths),
        "max_abs_err": max(errs[(kind, entry)], layer["max_abs_err"][kind],
                           long["max_abs_err"][kind]),
        "ms": min(layer[kind]["ms"]),
        "plain_ms": layer["backward"]["plain_ms"],
        "bound_ms": layer[kind]["bound_ms"],
        "bound_by": layer[kind]["bound_by"],
        "library_ms": layer[kind]["library_ms"],
        "long_context": {"design": long[kind]["design"],
                         "ms": min(long[kind]["ms"]),
                         "tflops": long[kind]["tflops"],
                         "plain_ms": long["backward"]["plain_ms"],
                         "bound_ms": long[kind]["bound_ms"],
                         "bound_by": long[kind]["bound_by"],
                         "library_ms": long[kind]["library_ms"]}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store-fit-orders", type=int, metavar="N")
    ap.add_argument("--analysis-lockcheck-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.analysis_lockcheck_child:
        if not torch.cuda.is_available():
            raise SystemExit("analysis_path (c) needs a CUDA card")
        print(json.dumps(analysis_lockcheck_child()), flush=True)
        return 0
    dev = phase_device()
    card = dev["nvidia_smi"]
    if args.store_fit_orders:
        store_fit_orders(card, args.store_fit_orders)
        return 0
    phase_build()
    err = phase_kernel()
    main_info = phase_main_path(card)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cli_info = phase_cli_path(card, root)
        serve_info = phase_serve_path(card, root)
        wire_info = phase_wire_path(card, root, cli_info)
        live_info = phase_live_path(card, root)
        cc_info = phase_creditcard_path(card)
        lstm_info = phase_lstm_path(card, root)
        mnist_info = phase_mnist_path(card)
        lc_info = phase_lifecycle_path(card, root, live_info)
        online_info = phase_online_path(card, root)
        obs_info = phase_obs_path(card, root)
        tele_info = phase_telemetry_path(card, root)
        ksql_info = phase_ksql_path(card)
        demo_info = phase_demo_path(card)
        store_info = phase_store_path(card)
        repl_info = phase_replication_path(card, root)
        cluster_info = phase_cluster_path(card, root)
        chaos_info = phase_chaos_path(card, root)
        twin_info = phase_twin_path(card, root)
        gateway_info = phase_gateway_path(card)
        analysis_info = phase_analysis_path(card)
        mesh_info = phase_mesh_path(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_fit_orders(card, store_info)
    timing = phase_timing(card, main_info["batches"], main_info["source"])
    attn_err = phase_attention_kernel()
    sf_info = phase_sensorformer_path(card)
    attn_timing = phase_attention_timing(card)
    bwd_err = phase_attention_backward_kernel()
    train_info = phase_sensorformer_train(card, sf_info["histories"])
    bwd_timing = phase_attention_backward_timing(card)
    long_paths = [bwd_timing[("long_context", entry)]["forward_backward"]
                  ["kernel_launches"] for entry in ("causal", "full")]
    paths = {"sensorformer_path": sf_info["kernel_launches"],
             "sensorformer_train": train_info["kernel_launches"],
             "long_context": {key: sum(p[key] for p in long_paths)
                              for key in flash_attention.launches},
             "serve_path": {key: serve_info["launches"][key]
                            for key in flash_attention.launches},
             "creditcard_path": {key: cc_info["counts"][key]
                                 for key in flash_attention.launches},
             "lstm_path": {key: lstm_info["counts"][key]
                           for key in flash_attention.launches},
             "mnist_path": {key: mnist_info["counts"][key]
                            for key in flash_attention.launches},
             "online_path": online_info["counts"],
             "obs_path": obs_info["counts"],
             "telemetry_path": tele_info["counts"]}
    design = timing["design"]
    emit({"phase_ends_s": PHASE_ENDS})
    emit({"kernels": [{
        "name": "fused_fit", "route": "cuda",
        "source": "iotml_torch/ops/csrc/fused_train.cu",
        "replaces": "iotml/ops/fused_train.py:64", "design": design,
        "launches": main_info["launches"] + cli_info["launches"]
        + serve_info["launches"]["fused_fit"] + wire_info["launches"]
        + live_info["launches"] + lc_info["launches"]
        + online_info["launches"] + obs_info["launches"]
        + tele_info["launches"]
        + ksql_info["launches"] + demo_info["launches"]
        + store_info["launches"] + repl_info["launches"]
        + cluster_info["launches"] + chaos_info["launches"]
        + twin_info["launches"] + gateway_info["launches"]
        + analysis_info["launches"] + mesh_info["launches"]
        + cc_info["launches"]
        + lstm_info["counts"]["fused_fit"]
        + mnist_info["counts"]["fused_fit"],
        "launches_by_path": {"main_path": main_info["launches"],
                             "cli_path": cli_info["launches"],
                             "serve_path":
                                 serve_info["launches"]["fused_fit"],
                             "wire_path": wire_info["launches"],
                             "live_path": live_info["launches"],
                             "lifecycle_path": lc_info["launches"],
                             "online_path": online_info["launches"],
                             "obs_path": obs_info["launches"],
                             "telemetry_path": tele_info["launches"],
                             "ksql_path": ksql_info["launches"],
                             "demo_path": demo_info["launches"],
                             "store_path": store_info["launches"],
                             "replication_path": repl_info["launches"],
                             "cluster_path": cluster_info["launches"],
                             "chaos_path": chaos_info["launches"],
                             "twin_path": twin_info["launches"],
                             "gateway_path": gateway_info["launches"],
                             "analysis_path": analysis_info["launches"],
                             "mesh_path": mesh_info["launches"],
                             "creditcard_path": cc_info["launches"],
                             "lstm_path": lstm_info["counts"]["fused_fit"],
                             "mnist_path":
                                 mnist_info["counts"]["fused_fit"]},
        "launches_by_design": {
            d: main_info["launches_by_design"][d]
            + cli_info["launches_by_design"][d]
            + wire_info["launches_by_design"][d]
            + live_info["launches_by_design"][d]
            + lc_info["launches_by_design"][d]
            + online_info["launches_by_design"][d]
            + obs_info["launches_by_design"][d]
            + tele_info["launches_by_design"][d]
            + ksql_info["launches_by_design"][d]
            + demo_info["launches_by_design"][d]
            + store_info["launches_by_design"][d]
            + repl_info["launches_by_design"][d]
            + cluster_info["launches_by_design"][d]
            + chaos_info["launches_by_design"][d]
            + twin_info["launches_by_design"][d]
            + gateway_info["launches_by_design"][d]
            + analysis_info["launches_by_design"][d]
            + mesh_info["launches_by_design"][d]
            + cc_info["launches_by_design"][d]
            for d in fused_train.DESIGNS},
        "max_abs_err": max(err, *timing["max_abs_err"].values(),
                           *timing["batch_256"]["max_abs_err"].values(),
                           cc_info["max_abs_err"], ksql_info["max_abs_err"],
                           demo_info["max_abs_err"],
                           store_info["max_abs_err"],
                           repl_info["max_abs_err"],
                           cluster_info["max_abs_err"],
                           chaos_info["max_abs_err"],
                           twin_info["max_abs_err"],
                           gateway_info["max_abs_err"],
                           analysis_info["max_abs_err"]),
        "store_path_launches_by_subphase": store_info["by_subphase"],
        "replication_path_launches_by_subphase": repl_info["by_subphase"],
        "cluster_path_launches_by_subphase": cluster_info["by_subphase"],
        "chaos_path_launches_by_scenario": chaos_info["by_scenario"],
        "ms": min(timing["kernel_ms"][design]),
        "ms_by_design": {d: min(t) for d, t in timing["kernel_ms"].items()},
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "step_loop_ms": timing["step_loop_ms"],
        "creditcard": {"design": "rows", "shape": cc_info["shape"],
                       "steps": cc_info["steps"], "ms": cc_info["kernel_ms"],
                       "plain_ms_per_step": cc_info["plain_ms_per_step"],
                       "bound_ms": cc_info["bound_ms"],
                       "bound_by": cc_info["bound_by"]},
        "twin": {key: twin_info["fit"][key] for key in (
            "design", "shape", "batches", "batch", "epochs", "kernel_ms",
            "us_per_step", "plain_ms", "bound_ms", "bound_by",
            "one_sm_bound_ms")}},
        attention_entry("flash_fwd_causal", "iotml/ops/attention.py:215",
                        "causal", paths, attn_err, attn_timing),
        attention_entry("flash_fwd_full", "iotml/ops/attention.py:149",
                        "full", paths, attn_err, attn_timing),
        backward_entry("flash_bwd_dkv_causal", "iotml/ops/attention.py:482",
                       "dkv", "causal", paths, bwd_err, bwd_timing),
        backward_entry("flash_bwd_dq_causal", "iotml/ops/attention.py:518",
                       "dq", "causal", paths, bwd_err, bwd_timing),
        backward_entry("flash_bwd_dkv_full", "iotml/ops/attention.py:402",
                       "dkv", "full", paths, bwd_err, bwd_timing),
        backward_entry("flash_bwd_dq_full", "iotml/ops/attention.py:447",
                       "dq", "full", paths, bwd_err, bwd_timing)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
