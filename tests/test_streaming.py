"""Device-resident streaming SLAM (filter/streaming.py).

The fused lax.scan loop must reproduce the host-driven
``EmbodiedSlamFilter`` pipeline (same jitted internals, same gating
rule) when fed the identical frame stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.filter import streaming
from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter
from slam_eslam_tpu.mapping import projection as proj
from slam_eslam_tpu.models.asguard import AsguardSim


def terrain(x, y):
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y)
    )


def _cfg(n=48):
    return dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        grid_size=10.0, grid_resolution=0.25,
        map_pool_blocks=n + 16, map_chain_length=3,
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2
        ),
    )


N_RAYS = 32
SCAN_META = (
    jnp.asarray(-np.pi / 2, jnp.float32),
    jnp.asarray(np.pi / N_RAYS, jnp.float32),
)


def _scan():
    return proj.LaserScan(
        ranges=jnp.full((N_RAYS,), 2.0),
        start_angle=SCAN_META[0],
        angular_resolution=SCAN_META[1],
    )


def _drive_host(cfg, steps):
    """Run the host driver; record the identical frame stream."""
    f = EmbodiedSlamFilter(config=cfg)
    sim = AsguardSim(terrain=terrain)
    f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
           use_shared_map=False)
    q = np.array([1.0, 0, 0, 0], np.float32)
    lb = (np.eye(3), np.zeros(3))

    frames = []
    stats = {"updated": 0, "mapped": 0}

    def cb(s):
        cs = s.contact_state()
        if f.update_contact((q, s.position.astype(np.float64)), cs):
            stats["updated"] += 1
        frames.append([cs, jnp.asarray(q),
                       jnp.asarray(s.position, jnp.float32),
                       jnp.full((N_RAYS,), 2.0, jnp.float32),
                       SCAN_META, jnp.asarray(False)])

    for _ in range(steps):
        sim.step(wheel_delta=0.3, on_substep=cb)
        if f.update_scan((q, sim.position.astype(np.float64)),
                         _scan(), lb):
            stats["mapped"] += 1
        # the host processes the scan after the last substep of the
        # step; mark that frame as carrying the scan
        frames[-1][5] = jnp.asarray(True)
    return f, frames, stats, lb


class TestStreamingSlam:
    def test_matches_host_driver(self):
        cfg = _cfg()
        f_host, frames, stats, lb = _drive_host(cfg, steps=6)

        f2 = EmbodiedSlamFilter(config=cfg)
        sim2 = AsguardSim(terrain=terrain)
        f2.init(pose=(np.array([0.0, 0.0, sim2.position[2]]), 0.0),
                use_shared_map=False)
        carry = streaming.StreamingState.create(f2.state, f2.pool)
        run = streaming.make_slam_scan_runner(cfg, laser2body=lb)
        carry, aux = run(carry, streaming.stack_frames(
            [tuple(fr) for fr in frames]
        ))

        assert int(np.asarray(aux["updated"]).sum()) == stats["updated"]
        assert int(np.asarray(aux["mapped"]).sum()) == stats["mapped"]
        np.testing.assert_allclose(
            np.asarray(carry.filter.particles.weight),
            np.asarray(f_host.state.particles.weight),
            rtol=1e-5, atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(carry.filter.particles.xy),
            np.asarray(f_host.state.particles.xy),
            rtol=1e-5, atol=1e-6,
        )
        # identical map pools: same allocation set, same active cells
        np.testing.assert_array_equal(
            np.asarray(carry.pool.allocated),
            np.asarray(f_host.pool.allocated),
        )
        np.testing.assert_array_equal(
            np.asarray(carry.pool.chain), np.asarray(f_host.pool.chain)
        )
        np.testing.assert_allclose(
            np.asarray(carry.pool.mean), np.asarray(f_host.pool.mean),
            rtol=1e-5, atol=1e-6,
        )

    def test_compacted_external_odometry_matches_full(self):
        """Measurement-compacted frames + precomputed odometry must
        reproduce the uncompacted in-scan run: compaction is
        semantics-preserving for the measurement (cap >= active count)
        but breaks the stance-foot odometry's across-frame slot
        correspondence — the round-4 harness bug where a compacted
        AsguardSim drive integrated ~zero motion.  The external-
        odometry path (``precompute_odometry`` from the full stream)
        restores exact behaviour."""
        cfg = _cfg()
        lb = (np.eye(3), np.zeros(3))
        sim = AsguardSim(terrain=terrain)
        q = np.array([1.0, 0, 0, 0], np.float32)
        frames_full, frames_cmp, full_cs = [], [], []

        def cb(s):
            cs = s.contact_state()
            full_cs.append(cs)
            base = [jnp.asarray(q),
                    jnp.asarray(s.position, jnp.float32),
                    jnp.full((N_RAYS,), 2.0, jnp.float32),
                    SCAN_META, jnp.asarray(False)]
            frames_full.append([cs] + [jnp.asarray(x) for x in base])
            frames_cmp.append([cs.compact(8)]
                              + [jnp.asarray(x) for x in base])

        for _ in range(5):
            sim.step(wheel_delta=0.3, on_substep=cb)
            frames_full[-1][5] = jnp.asarray(True)
            frames_cmp[-1][5] = jnp.asarray(True)

        def fresh_carry():
            f = EmbodiedSlamFilter(config=cfg)
            s2 = AsguardSim(terrain=terrain)
            f.init(pose=(np.array([0.0, 0.0, s2.position[2]]), 0.0),
                   use_shared_map=False, num_contact_points=20)
            return streaming.StreamingState.create(f.state, f.pool)

        run_full = streaming.make_slam_scan_runner(cfg, laser2body=lb)
        c_full, _ = run_full(
            fresh_carry(),
            streaming.stack_frames([tuple(fr) for fr in frames_full]),
        )

        odos = streaming.precompute_odometry(
            20,
            jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *full_cs),
            jnp.stack([jnp.asarray(q)] * len(frames_cmp)), cfg=cfg,
        )
        run_cmp = streaming.make_slam_scan_runner(
            cfg, laser2body=lb, external_odometry=True)
        c_cmp, _ = run_cmp(
            fresh_carry(),
            streaming.stack_frames([tuple(fr) for fr in frames_cmp]),
            odos,
        )

        # the drive must actually MOVE (the compacted-odometry bug read
        # ~zero motion over the whole trajectory)
        assert float(np.linalg.norm(
            np.asarray(c_full.filter.particles.xy).mean(0))) > 0.05
        np.testing.assert_allclose(
            np.asarray(c_cmp.filter.particles.xy),
            np.asarray(c_full.filter.particles.xy),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(c_cmp.filter.particles.weight),
            np.asarray(c_full.filter.particles.weight),
            rtol=1e-4, atol=1e-8,
        )

    def test_camera_matches_host_driver(self):
        """Mixed laser + distance-image frames: the fused camera branch
        (gating, projection, always-merge semantics,
        EmbodiedSlamFilter.cpp:239-309) must reproduce the host driver's
        update_distance_image path."""
        cfg = _cfg()
        h, w = 6, 8
        intr = (0.1, 0.1, -0.35, -0.25)
        cb = (np.eye(3), np.array([0.1, 0.0, 0.2]))
        lb = (np.eye(3), np.zeros(3))

        def dimg_at(i):
            rng = np.random.default_rng(100 + i)
            return (2.0 + 0.1 * rng.standard_normal((h, w))).astype(
                np.float32
            )

        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        q = np.array([1.0, 0, 0, 0], np.float32)
        frames = []
        stats = {"updated": 0, "mapped": 0, "cam": 0}

        def sub(s):
            cs = s.contact_state()
            if f.update_contact((q, s.position.astype(np.float64)), cs):
                stats["updated"] += 1
            frames.append([
                cs, jnp.asarray(q), jnp.asarray(s.position, jnp.float32),
                jnp.full((N_RAYS,), 2.0, jnp.float32), SCAN_META,
                jnp.asarray(False),
                jnp.zeros((h, w), jnp.float32), jnp.asarray(False),
            ])

        for i in range(6):
            sim.step(wheel_delta=0.3, on_substep=sub)
            if f.update_scan((q, sim.position.astype(np.float64)),
                             _scan(), lb):
                stats["mapped"] += 1
            frames[-1][5] = jnp.asarray(True)
            d = dimg_at(i)
            img = proj.DistanceImage(
                data=jnp.asarray(d),
                scale_x=jnp.asarray(intr[0], jnp.float32),
                scale_y=jnp.asarray(intr[1], jnp.float32),
                center_x=jnp.asarray(intr[2], jnp.float32),
                center_y=jnp.asarray(intr[3], jnp.float32),
            )
            if f.update_distance_image(
                (q, sim.position.astype(np.float64)), img, cb
            ):
                stats["cam"] += 1
            frames[-1][6] = jnp.asarray(d)
            frames[-1][7] = jnp.asarray(True)
        assert stats["cam"] > 0, "camera gate never fired in the fixture"

        f2 = EmbodiedSlamFilter(config=cfg)
        sim2 = AsguardSim(terrain=terrain)
        f2.init(pose=(np.array([0.0, 0.0, sim2.position[2]]), 0.0),
                use_shared_map=False)
        carry = streaming.StreamingState.create(f2.state, f2.pool)
        run = streaming.make_slam_scan_runner(
            cfg, laser2body=lb, camera2body=cb, camera_intrinsics=intr
        )
        carry, aux = run(carry, streaming.stack_frames(
            [tuple(fr) for fr in frames]
        ))

        assert int(np.asarray(aux["updated"]).sum()) == stats["updated"]
        assert int(np.asarray(aux["mapped"]).sum()) == stats["mapped"]
        assert int(np.asarray(aux["cam_mapped"]).sum()) == stats["cam"]
        assert int(carry.update_idx) == f.update_idx
        np.testing.assert_allclose(
            np.asarray(carry.filter.particles.weight),
            np.asarray(f.state.particles.weight),
            rtol=1e-5, atol=1e-8,
        )
        np.testing.assert_array_equal(
            np.asarray(carry.pool.chain), np.asarray(f.pool.chain)
        )
        np.testing.assert_allclose(
            np.asarray(carry.pool.mean), np.asarray(f.pool.mean),
            rtol=1e-5, atol=1e-6,
        )

    def test_camera_texture_matches_host(self):
        """Texture RGB riding on camera merges (ImageRGB24 path,
        EmbodiedSlamFilter.cpp:259-275): streaming camera_texture=True
        must reproduce the host driver's texture colours on the pool."""
        cfg = _cfg(n=12)
        h, w = 4, 6
        intr = (0.1, 0.1, -0.3, -0.2)
        cb = (np.eye(3), np.zeros(3))
        rng = np.random.default_rng(5)
        d = (2.0 + 0.05 * rng.standard_normal((h, w))).astype(np.float32)
        tex = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)

        def build():
            f = EmbodiedSlamFilter(config=cfg)
            sim = AsguardSim(terrain=terrain)
            f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
                   use_shared_map=False)
            return f, sim

        f, sim = build()
        q = np.array([1.0, 0, 0, 0], np.float32)
        frames = []

        def sub(s):
            cs = s.contact_state()
            f.update_contact((q, s.position.astype(np.float64)), cs)
            frames.append([
                cs, jnp.asarray(q), jnp.asarray(s.position, jnp.float32),
                jnp.zeros((1,), jnp.float32),
                (jnp.asarray(0.0, jnp.float32),
                 jnp.asarray(1.0, jnp.float32)),
                jnp.asarray(False),
                jnp.zeros((h, w), jnp.float32), jnp.asarray(False),
                jnp.zeros((h, w, 3), jnp.float32),
            ])

        img = proj.DistanceImage(
            data=jnp.asarray(d),
            scale_x=jnp.asarray(intr[0], jnp.float32),
            scale_y=jnp.asarray(intr[1], jnp.float32),
            center_x=jnp.asarray(intr[2], jnp.float32),
            center_y=jnp.asarray(intr[3], jnp.float32),
        )
        for _ in range(2):
            sim.step(wheel_delta=0.3, on_substep=sub)
            # the image arrives on the step's last substep frame — the
            # same interleaving the streaming loop sees
            f.update_distance_image(
                (q, sim.position.astype(np.float64)), img, cb,
                texture=tex,
            )
            frames[-1][6] = jnp.asarray(d)
            frames[-1][7] = jnp.asarray(True)
            frames[-1][8] = jnp.asarray(tex)
        frames = [tuple(fr) for fr in frames]

        f2, _ = build()
        carry = streaming.StreamingState.create(f2.state, f2.pool)
        run = streaming.make_slam_scan_runner(
            cfg, camera2body=cb, camera_intrinsics=intr,
            camera_texture=True,
        )
        carry, aux = run(carry, streaming.stack_frames(frames))
        assert int(np.asarray(aux["cam_mapped"]).sum()) >= 1
        assert f.pool.color is not None
        np.testing.assert_allclose(
            np.asarray(carry.pool.color), np.asarray(f.pool.color),
            rtol=1e-5, atol=1e-6,
        )
        # some patch actually carries non-zero texture colour
        assert float(np.abs(np.asarray(carry.pool.color)).max()) > 0

    def test_camera_frames_from_log(self, tmp_path):
        """DISTANCE_IMAGE records flow through load_stream into the
        device-resident runner (camera=True round trip)."""
        from slam_eslam_tpu.io import logio

        cfg = _cfg(n=16)
        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        q = np.array([1.0, 0, 0, 0], np.float32)
        h, w = 4, 6
        intr = (0.1, 0.1, -0.3, -0.2)
        cb = (np.eye(3), np.zeros(3))
        path = str(tmp_path / "cam.eslg")
        frames = []

        with logio.LogWriter(path) as wr:
            step_i = [0]

            def sub(s):
                ts = 1000 + step_i[0] * 10
                step_i[0] += 1
                cs = s.contact_state()
                has_img = step_i[0] % 4 == 0
                d = (2.0 + 0.05 * step_i[0]) * np.ones((h, w), np.float32)
                wr.write_contact_state(cs, timestamp_ns=ts)
                wr.write_orientation(q, timestamp_ns=ts)
                wr.write_pose(s.position, q, timestamp_ns=ts)
                if has_img:
                    wr.write_distance_image(d, *intr, timestamp_ns=ts)
                frames.append((
                    cs, jnp.asarray(q),
                    jnp.asarray(s.position, jnp.float32),
                    jnp.zeros((1,), jnp.float32),
                    (jnp.asarray(0.0, jnp.float32),
                     jnp.asarray(1.0, jnp.float32)),
                    jnp.asarray(False),
                    jnp.asarray(d), jnp.asarray(has_img),
                ))

            for _ in range(2):
                sim.step(wheel_delta=0.3, on_substep=sub)

        log_frames, ts, meta = streaming.frames_from_log(path, camera=True)
        np.testing.assert_allclose(meta, intr, rtol=1e-6)
        carry0 = streaming.StreamingState.create(f.state, f.pool)
        run = streaming.make_slam_scan_runner(
            cfg, camera2body=cb, camera_intrinsics=intr
        )
        c_mem, a_mem = run(carry0, streaming.stack_frames(frames))
        c_log, a_log = run(carry0, log_frames)
        np.testing.assert_array_equal(
            np.asarray(a_mem["cam_mapped"]), np.asarray(a_log["cam_mapped"])
        )
        assert int(np.asarray(a_log["cam_mapped"]).sum()) > 0
        np.testing.assert_allclose(
            np.asarray(c_mem.pool.mean), np.asarray(c_log.pool.mean),
            rtol=1e-6,
        )

    def test_sharded_matches_single_device(self):
        """Particles + chain rows sharded over the virtual mesh, blocks
        replicated: results must equal the single-device run."""
        import pytest

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")
        from slam_eslam_tpu.parallel import sharding as shd

        cfg = _cfg(n=64)
        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        q = np.array([1.0, 0, 0, 0], np.float32)
        frames = []

        def cb(s):
            frames.append((s.contact_state(), jnp.asarray(q),
                           jnp.asarray(s.position, jnp.float32),
                           jnp.full((N_RAYS,), 2.0, jnp.float32),
                           SCAN_META, jnp.asarray(True)))

        for _ in range(4):
            sim.step(wheel_delta=0.3, on_substep=cb)
        stacked = streaming.stack_frames(frames)

        carry0 = streaming.StreamingState.create(f.state, f.pool)
        run1 = streaming.make_slam_scan_runner(cfg)
        c1, a1 = run1(carry0, stacked)

        mesh = shd.make_mesh(8)
        ps = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("dp")
        )
        fs = shd.shard_state(f.state, mesh)
        pool_sh = dataclasses.replace(
            f.pool, chain=jax.device_put(f.pool.chain, ps)
        )
        carry_sh = streaming.StreamingState.create(fs, pool_sh)
        run8 = streaming.make_slam_scan_runner(cfg, mesh=mesh)
        c2, a2 = run8(carry_sh, stacked)

        np.testing.assert_allclose(
            np.asarray(c1.filter.particles.weight),
            np.asarray(c2.filter.particles.weight),
            rtol=2e-4, atol=1e-7,
        )
        np.testing.assert_allclose(
            np.asarray(c1.pool.mean), np.asarray(c2.pool.mean),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(a1["centroid"]), np.asarray(a2["centroid"]),
            atol=1e-5,
        )

    def test_sharded_pool_colocated_matches_single_device(self):
        """Block-sharded pool with range-local allocation
        (map_pool_shards == mesh size): results equal the single-device
        run bit-for-bit (the allocation pattern depends only on the
        config, never the device count), block memory is physically
        split over the mesh, and nothing is silently replicated."""
        import pytest

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")
        from slam_eslam_tpu.parallel import sharding as shd

        cfg = dataclasses.replace(_cfg(n=64), map_pool_shards=8)
        assert cfg.map_pool_blocks % 8 == 0

        def build():
            f = EmbodiedSlamFilter(config=cfg)
            sim = AsguardSim(terrain=terrain)
            f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
                   use_shared_map=False)
            return f, sim

        f, sim = build()
        q = np.array([1.0, 0, 0, 0], np.float32)
        frames = []

        def cb(s):
            frames.append((s.contact_state(), jnp.asarray(q),
                           jnp.asarray(s.position, jnp.float32),
                           jnp.full((N_RAYS,), 2.0, jnp.float32),
                           SCAN_META, jnp.asarray(True)))

        for _ in range(4):
            sim.step(wheel_delta=0.3, on_substep=cb)
        stacked = streaming.stack_frames(frames)

        carry0 = streaming.StreamingState.create(f.state, f.pool)
        run1 = streaming.make_slam_scan_runner(cfg)
        c1, a1 = run1(carry0, stacked)

        mesh = shd.make_mesh(8)
        fs = shd.shard_state(f.state, mesh)
        pool_sh = shd.shard_pool(f.pool, mesh)
        # the pool block axis is physically split over the mesh
        assert not pool_sh.mean.sharding.is_fully_replicated
        shard_rows = {s.data.shape[0] for s in
                      pool_sh.mean.addressable_shards}
        assert shard_rows == {f.pool.b // 8}
        carry_sh = streaming.StreamingState.create(fs, pool_sh)
        run8 = streaming.make_slam_scan_runner(cfg, mesh=mesh)
        c2, a2 = run8(carry_sh, stacked)

        np.testing.assert_array_equal(
            np.asarray(c1.pool.chain), np.asarray(c2.pool.chain)
        )
        np.testing.assert_allclose(
            np.asarray(c1.pool.mean), np.asarray(c2.pool.mean),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(c1.filter.particles.weight),
            np.asarray(c2.filter.particles.weight),
            rtol=2e-4, atol=1e-7,
        )
        np.testing.assert_allclose(
            np.asarray(a1["centroid"]), np.asarray(a2["centroid"]),
            atol=1e-5,
        )
        # co-location invariant: every particle's ACTIVE block sits in
        # its own allocation range (= its device's block range)
        chain = np.asarray(c2.pool.chain)
        n, b = f.pool.n, f.pool.b
        prange = np.arange(n) // (n // 8)
        brange = chain[:, 0] // (b // 8)
        np.testing.assert_array_equal(prange, brange)

    def test_sharded_colourless_pool_matches_single_device(self):
        """A colour-free pool sharded over the mesh (active blocks
        co-located by map_pool_shards + re-homing): the partitioned
        merge must equal the single-device merge."""
        import pytest

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")
        from slam_eslam_tpu.parallel import sharding as shd

        cfg = dataclasses.replace(
            _cfg(n=64), map_pool_shards=8, map_pool_color=False,
        )

        def build():
            f = EmbodiedSlamFilter(config=cfg)
            sim = AsguardSim(terrain=terrain)
            f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
                   use_shared_map=False)
            return f, sim

        f, sim = build()
        q = np.array([1.0, 0, 0, 0], np.float32)
        frames = []

        def cb(s):
            frames.append((s.contact_state(), jnp.asarray(q),
                           jnp.asarray(s.position, jnp.float32),
                           jnp.full((N_RAYS,), 2.0, jnp.float32),
                           SCAN_META, jnp.asarray(True)))

        for _ in range(4):
            sim.step(wheel_delta=0.3, on_substep=cb)
        stacked = streaming.stack_frames(frames)

        carry0 = streaming.StreamingState.create(f.state, f.pool)
        run_x = streaming.make_slam_scan_runner(cfg)
        cx, _ = run_x(carry0, stacked)

        mesh = shd.make_mesh(8)
        carry_sh = streaming.StreamingState.create(
            shd.shard_state(f.state, mesh), shd.shard_pool(f.pool, mesh)
        )
        run_p = streaming.make_slam_scan_runner(cfg, mesh=mesh)
        cp, _ = run_p(carry_sh, stacked)

        np.testing.assert_array_equal(
            np.asarray(cx.pool.chain), np.asarray(cp.pool.chain)
        )
        np.testing.assert_array_equal(
            np.asarray(cx.pool.valid), np.asarray(cp.pool.valid)
        )
        np.testing.assert_allclose(
            np.asarray(cx.pool.mean), np.asarray(cp.pool.mean),
            rtol=1e-4, atol=1e-5,
        )

    def test_frames_from_log_roundtrip(self, tmp_path):
        """Record a traverse through the native log runtime, then feed
        the whole log into the device-resident runner via the batched
        C gather path — results must equal the in-memory frame stream."""
        from slam_eslam_tpu.io import logio

        cfg = _cfg(n=16)
        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        q = np.array([1.0, 0, 0, 0], np.float32)
        path = str(tmp_path / "traverse.eslg")
        frames = []

        with logio.LogWriter(path) as w:
            step_i = [0]

            def cb(s):
                ts = 1000 + step_i[0] * 10
                step_i[0] += 1
                cs = s.contact_state()
                has_scan = step_i[0] % 5 == 0
                w.write_contact_state(cs, timestamp_ns=ts)
                w.write_orientation(q, timestamp_ns=ts)
                w.write_pose(s.position, q, timestamp_ns=ts)
                if has_scan:
                    w.write_scan(np.full(N_RAYS, 2.0), float(SCAN_META[0]),
                                 float(SCAN_META[1]), timestamp_ns=ts)
                frames.append((cs, jnp.asarray(q),
                               jnp.asarray(s.position, jnp.float32),
                               jnp.full((N_RAYS,), 2.0, jnp.float32),
                               SCAN_META, jnp.asarray(has_scan)))

            for _ in range(3):
                sim.step(wheel_delta=0.3, on_substep=cb)

        log_frames, ts = streaming.frames_from_log(path)
        assert ts.shape == (len(frames),)

        carry0 = streaming.StreamingState.create(f.state, f.pool)
        run = streaming.make_slam_scan_runner(cfg)
        c_mem, a_mem = run(carry0, streaming.stack_frames(frames))
        c_log, a_log = run(carry0, log_frames)
        np.testing.assert_array_equal(
            np.asarray(a_mem["mapped"]), np.asarray(a_log["mapped"])
        )
        np.testing.assert_allclose(
            np.asarray(c_mem.filter.particles.weight),
            np.asarray(c_log.filter.particles.weight),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(a_mem["centroid"]), np.asarray(a_log["centroid"]),
            atol=1e-6,
        )

    def test_run_stream_api(self):
        """EmbodiedSlamFilter.run_stream: the class-level entry point to
        the fused loop must match driving the class frame by frame."""
        cfg = _cfg()
        f_host, frames, stats, lb = _drive_host(cfg, steps=4)

        f2 = EmbodiedSlamFilter(config=cfg)
        sim2 = AsguardSim(terrain=terrain)
        f2.init(pose=(np.array([0.0, 0.0, sim2.position[2]]), 0.0),
                use_shared_map=False)
        aux = f2.run_stream(
            streaming.stack_frames([tuple(fr) for fr in frames]),
            laser2body=lb,
        )
        assert int(np.asarray(aux["updated"]).sum()) == stats["updated"]
        assert int(np.asarray(aux["mapped"]).sum()) == stats["mapped"]
        assert f2.update_idx == f_host.update_idx
        np.testing.assert_allclose(
            np.asarray(f2.state.particles.weight),
            np.asarray(f_host.state.particles.weight),
            rtol=1e-5, atol=1e-8,
        )
        # gate anchors resumed: a second stream continues seamlessly
        np.testing.assert_allclose(
            f2.ud_pose[:3, 3], f_host.ud_pose[:3, 3], atol=1e-6
        )

    def test_snapshot_recorder(self, tmp_path):
        """Periodic-render harness (live-viz analog): every N-th update
        produces a frame with particles + trajectories + inspected map."""
        from slam_eslam_tpu.viz.snapshots import SnapshotRecorder

        cfg = _cfg(n=8)
        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        rec = SnapshotRecorder(str(tmp_path / "frames"), every=2)
        q = np.array([1.0, 0, 0, 0], np.float32)
        wrote = []
        for _ in range(2):
            sim.step(wheel_delta=0.3, on_substep=lambda s: None)
            f.update_contact((q, sim.position.astype(np.float64)),
                             sim.contact_state())
            wrote.append(rec.maybe(f, truth=sim.position))
        assert wrote[0] is not None and wrote[1] is None
        import os

        assert os.path.exists(wrote[0])
        assert len(rec.frames) == 1

    def test_quat_from_matrix_roundtrip(self):
        from slam_eslam_tpu.utils import geometry

        rng = np.random.default_rng(0)
        for _ in range(20):
            q = rng.normal(size=4)
            q = q / np.linalg.norm(q)
            if q[0] < 0:
                q = -q
            m = geometry.quat_to_matrix(jnp.asarray(q, jnp.float32))
            q2 = np.asarray(geometry.quat_from_matrix(m))
            np.testing.assert_allclose(q2, q, atol=1e-5)

    def test_hash_reinjection_in_stream(self):
        """The hash-reinjection lax.cond must fire every `period`
        projections inside the fused loop and actually replace
        low-weight particles (different trajectory from no-hash)."""
        from slam_eslam_tpu.config import SurfaceHashConfig
        from slam_eslam_tpu.filter.surface_hash import SurfaceHash
        from slam_eslam_tpu.models import sim as simlib

        cfg = _cfg(n=32)
        hcfg = SurfaceHashConfig(
            use_hash=True, slope_bins=8, angular_steps=4, period=3,
            percentage=0.5, avg_factor=0.1,
        )
        grid = simlib.terrain_grid(
            terrain, nx=32, ny=32, resolution=0.3, origin=(-4.8, -4.8)
        )
        h = SurfaceHash.create(hcfg, grid)

        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        q = np.array([1.0, 0, 0, 0], np.float32)
        frames = []

        def cb(s):
            frames.append((s.contact_state(), jnp.asarray(q),
                           jnp.asarray(s.position, jnp.float32),
                           jnp.full((N_RAYS,), 2.0, jnp.float32),
                           SCAN_META, jnp.asarray(False)))

        for _ in range(2):
            sim.step(wheel_delta=0.3, on_substep=cb)
        stacked = streaming.stack_frames(frames)

        carry0 = streaming.StreamingState.create(f.state, f.pool)
        run_plain = streaming.make_slam_scan_runner(cfg)
        run_hash = streaming.make_slam_scan_runner(cfg, hash_=h)
        c_plain, _ = run_plain(carry0, stacked)
        c_hash, _ = run_hash(carry0, stacked)
        w_plain = np.asarray(c_plain.filter.particles.xy)
        w_hash = np.asarray(c_hash.filter.particles.xy)
        assert np.isfinite(w_hash).all()
        assert not np.allclose(w_plain, w_hash)

    def test_checkpoint_roundtrip(self, tmp_path):
        """StreamingState (filter + pool + gate anchors) must survive an
        Orbax save/restore — checkpoint/resume for the full SLAM loop."""
        from slam_eslam_tpu.utils import checkpoint as ckpt

        cfg = _cfg(n=16)
        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        carry = streaming.StreamingState.create(f.state, f.pool)
        path = str(tmp_path / "stream_ckpt")
        ckpt.save_state(path, carry)
        restored = ckpt.restore_state(path, carry)
        eq = jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
            carry, restored,
        ))
        assert eq

    def test_single_dispatch(self):
        """The whole trajectory must run as one compiled call (the
        device-bound benchmark shape)."""
        cfg = _cfg(n=16)
        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False)
        frames = []
        q = np.array([1.0, 0, 0, 0], np.float32)

        def cb(s):
            frames.append((s.contact_state(), jnp.asarray(q),
                           jnp.asarray(s.position, jnp.float32),
                           jnp.full((N_RAYS,), 2.0, jnp.float32),
                           SCAN_META, jnp.asarray(True)))

        for _ in range(3):
            sim.step(wheel_delta=0.3, on_substep=cb)

        carry = streaming.StreamingState.create(f.state, f.pool)
        run = streaming.make_slam_scan_runner(cfg)
        with jax.checking_leaks():
            carry, aux = run(carry, streaming.stack_frames(frames))
        assert aux["centroid"].shape == (len(frames), 3)
        assert bool(np.isfinite(
            np.asarray(carry.filter.particles.weight)).all())


class TestNegativeInformationE2E:
    """Scripted-ray negative information in per-particle mode: a stale
    patch on the ray path is removed when
    ``grid_use_negative_information=True`` (laser path only,
    ``EmbodiedSlamFilter.cpp:160``)."""

    STALE_XY = (1.0, 0.0)   # on the forward ray, inside free space
    Z0 = 0.3

    def _filter(self, neg, n=8):
        cfg = dataclasses.replace(
            _cfg(n),
            grid_use_negative_information=neg,
            initial_translation_error=(1e-4, 1e-4, 0.0),
            initial_rotation_error=(0.0, 0.0, 1e-4),
        )
        f = EmbodiedSlamFilter(config=cfg)
        f.init(pose=(np.array([0.0, 0.0, self.Z0]), 0.0),
               use_shared_map=False)
        # seed the stale patch into every particle's active block at
        # the particle z (free samples ride at ray height ~= p.z)
        import slam_eslam_tpu.mapping.map_pool as mp
        from tests.test_map_pool import write_cell

        for b in range(n):
            f.pool = write_cell(f.pool, b, *self.STALE_XY, self.Z0)
        return cfg, f

    def _stale_found(self, f):
        import slam_eslam_tpu.mapping.map_pool as mp

        lookup = mp.chain_lookup(f.pool)
        pts = jnp.array([[*self.STALE_XY, self.Z0]])
        found = [
            bool(lookup(i, pts)[0][0]) for i in range(f.pool.n)
        ]
        return np.mean(found)

    def test_host_laser_path(self):
        for neg, expect_gone in [(True, True), (False, False)]:
            cfg, f = self._filter(neg)
            assert self._stale_found(f) == 1.0
            fired = f.update_scan(
                (np.array([1.0, 0, 0, 0]), np.zeros(3)), _scan(),
                (np.eye(3), np.zeros(3)),
            )
            assert fired
            frac = self._stale_found(f)
            if expect_gone:
                assert frac == 0.0, (
                    f"stale patch survived the negative pass ({frac})"
                )
            else:
                assert frac == 1.0, "patch erased with the flag off"

    def test_streaming_laser_path(self):
        for neg, expect_gone in [(True, True), (False, False)]:
            cfg, f = self._filter(neg)
            sim = AsguardSim(terrain=lambda x, y: np.zeros_like(
                np.asarray(x, float)
            ))
            q = np.array([1.0, 0, 0, 0], np.float32)
            frames = [(
                sim.contact_state(), jnp.asarray(q),
                jnp.zeros(3, jnp.float32),
                jnp.full((N_RAYS,), 2.0, jnp.float32),
                SCAN_META, jnp.asarray(True),
            )]
            aux = f.run_stream(
                streaming.stack_frames(frames),
                laser2body=(np.eye(3), np.zeros(3)),
            )
            assert int(np.asarray(aux["mapped"]).sum()) == 1
            frac = self._stale_found(f)
            if expect_gone:
                assert frac == 0.0, (
                    f"stale patch survived streaming negative pass ({frac})"
                )
            else:
                assert frac == 1.0, "patch erased with the flag off"
