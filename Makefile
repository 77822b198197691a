.PHONY: test test-shard1 test-shard2 test-cov test-multidevice deps \
	lint test-sanitize \
	bench-stream bench-fleet bench-adapt bench-int bench-int4 \
	bench-control bench bench-mesh bench-serve bench-cascade

deps:
	pip install -r requirements-dev.txt

# Tier-1 verify (ROADMAP.md): must pass on CPU.
test:
	PYTHONPATH=src python -m pytest -x -q

# CI shards: two parallel jobs that together run the full suite.
# tests/test_ci_shards.py asserts SHARD1 + SHARD2 == every tests/test_*.py,
# so a new test file that lands in neither shard fails CI.
SHARD1_FILES = tests/test_kernels.py tests/test_kernels_batch.py \
	tests/test_kernels_perm.py tests/test_int_datapath.py \
	tests/test_workingset.py tests/test_parity_matrix.py \
	tests/test_stream.py tests/test_fleet.py \
	tests/test_sensing.py tests/test_adc_quantize.py tests/test_golden.py \
	tests/test_sharding.py tests/test_control_loop.py tests/test_serve.py \
	tests/test_cascade.py tests/test_torch_kernels.py \
	tests/test_torch_stream.py tests/test_torch_encode.py \
	tests/test_torch_fleet.py tests/test_torch_serve.py \
	tests/test_torch_cascade.py tests/test_torch_int_expanded.py \
	tests/test_torch_synthetic.py tests/test_torch_baselines.py \
	tests/test_torch_mesh.py tests/test_torch_cascade_mesh.py \
	tests/test_torch_train_mesh.py tests/test_torch_train_loop_mesh.py
SHARD2_FILES = tests/test_arch_smoke.py tests/test_cells.py \
	tests/test_data_pipeline.py tests/test_gate.py tests/test_hdc_core.py \
	tests/test_hypersense.py tests/test_online.py tests/test_system.py \
	tests/test_train_runtime.py tests/test_ci_shards.py \
	tests/test_analysis.py tests/test_torch_core.py \
	tests/test_torch_hypersense.py tests/test_torch_fragment_model.py \
	tests/test_torch_scores_int.py tests/test_torch_scores_f32.py \
	tests/test_torch_similarity.py tests/test_torch_energy.py \
	tests/test_torch_checkpoint.py tests/test_torch_models.py \
	tests/test_torch_gate.py tests/test_torch_flags.py \
	tests/test_torch_optim.py tests/test_torch_sharding.py \
	tests/test_torch_roofline.py tests/test_torch_cells.py \
	tests/test_torch_memory_model.py tests/test_torch_dryrun.py \
	tests/test_torch_lm_dense.py tests/test_torch_decode.py \
	tests/test_torch_moe.py tests/test_torch_lm_moe.py \
	tests/test_torch_ssm.py tests/test_torch_lm_hybrid.py \
	tests/test_torch_xlstm.py tests/test_torch_lm_xlstm.py \
	tests/test_torch_compress.py tests/test_torch_train_loop.py \
	tests/test_torch_remat.py tests/test_torch_examples.py \
	tests/test_torch_analysis.py

# PYTEST_EXTRA lets CI attach coverage flags (see .github/workflows/ci.yml);
# plain local runs need no pytest-cov install.
test-shard1:
	PYTHONPATH=src python -m pytest -x -q $(PYTEST_EXTRA) $(SHARD1_FILES)

test-shard2:
	PYTHONPATH=src python -m pytest -x -q $(PYTEST_EXTRA) $(SHARD2_FILES)

# Static gates: ruff (baseline hygiene; skipped with a notice when not
# installed — the container image has no pip access) + the repo-specific
# jit/Pallas linter + the port's eager-PyTorch/CUDA linter (RA006 also
# reads the kernels' .cu sources). `--check` exits nonzero on any
# unwaived finding.
lint:
	@if command -v ruff >/dev/null 2>&1; then \
		ruff check src tests benchmarks; \
	else \
		echo "ruff not installed; skipping ruff (repro.analysis still runs)"; \
	fi
	PYTHONPATH=src python -m repro.analysis --check src
	PYTHONPATH=src python -m repro_torch.analysis --check src/repro_torch

# Shard 1 under the runtime sanitizer harness: jax_debug_nans,
# tracer-leak checks, the suite-wide compile ledger, and transfer guards
# armed inside every sanitize.no_implicit_transfers() block.
test-sanitize:
	REPRO_SANITIZE=1 $(MAKE) test-shard1

# Coverage-gated kernels+sensing run (shard 1 exercises those packages).
test-cov:
	$(MAKE) test-shard1 PYTEST_EXTRA="--cov=src/repro/kernels \
	--cov=src/repro/sensing --cov-report=term --cov-fail-under=70"

# shard_map / 2-D (sensors x hyperdim) sharding against a real 8-device
# host mesh. MESH=4x2 (etc.) filters test_parity_matrix's mesh matrix to
# one shape via FLEET_TEST_MESH so CI can fan the shapes out across jobs;
# unset, every shape runs in-process.
test-multidevice:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	$(if $(MESH),FLEET_TEST_MESH=$(MESH)) PYTHONPATH=src \
	python -m pytest -x -q tests/test_fleet.py tests/test_sharding.py \
	tests/test_stream.py tests/test_parity_matrix.py tests/test_online.py \
	tests/test_golden.py tests/test_serve.py

bench-stream:
	PYTHONPATH=src python benchmarks/stream_throughput.py

bench-fleet:
	PYTHONPATH=src python benchmarks/fleet_throughput.py

bench-adapt:
	PYTHONPATH=src python benchmarks/adaptation.py

bench-int:
	PYTHONPATH=src python benchmarks/int_datapath.py

# the CI regression gate for the integer datapaths (int8 rolling-shift
# kernel vs the expanded-slab baseline, packed int4 AUC parity, binary
# D-vs-AUC curve, large-W working set, determinism)
bench-int4:
	PYTHONPATH=src python benchmarks/int_datapath.py --check

bench-control:
	PYTHONPATH=src python benchmarks/control_loop.py

# the 2-D mesh scale-out gate: S=1024 on the sensor axis, D=16384 on the
# hyperdim axis (forced-8-device host mesh), bitwise parity + VMEM
# certification enforced
bench-mesh:
	PYTHONPATH=src python benchmarks/fleet_throughput.py --mesh --check

# the serving-layer gate: async double-buffered FleetService >= synchronous
# FleetRunner fps, bitwise parity churn-off, zero recompiles under churn,
# bitwise checkpoint kill-and-resume
bench-serve:
	PYTHONPATH=src python benchmarks/serve_throughput.py --check

# the full-loop gate → detector cascade gate: batched async backbone
# serving bitwise-equal to eager per-frame evaluation, exactly one
# backbone compile across ragged HP drains, duty-cycled system energy
# strictly below the always-on backbone at matched missed positives
bench-cascade:
	PYTHONPATH=src python -m benchmarks.fig16_speedup --system --check

bench:
	PYTHONPATH=src python -m benchmarks.run
