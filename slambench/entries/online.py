"""``runtime.online.OnlineSLAM``: a session a request, on the mix's
``pool`` worlds in turn.  Every frame is pushed as soon as ``push()``
returns (``chunk_size`` frames a flush), then ``finish(refine=True)``
runs, as ``api.run_online`` does.  The traced sub-window is a session's
first ``trace.chunks`` flushes."""
import time

from slambench.harness import drive
from slambench.reference import compare


class Entry(drive.Entry):
    def n_worlds(self, traffic, config):
        return int(traffic["pool"])

    def session(self, k, stop_after_chunks=0):
        """A session over world k; with ``stop_after_chunks`` it ends after
        that many flushes, unfinished."""
        from icm_slam_tpu_torch.runtime.online import OnlineSLAM
        w, C = self.worlds[k], int(self.traffic["chunk_size"])
        slam = OnlineSLAM(self.solver, self.device, chunk_size=C)
        chunk_s = []
        t0 = time.perf_counter()
        for t in range(w.T):
            a = time.perf_counter()
            with self.span("slambench.push"):
                slam.push(w.scans[t], w.odom[t], w.u[t])
            if t and t % C == 0:
                chunk_s.append(time.perf_counter() - a)
                if len(chunk_s) == stop_after_chunks:
                    return drive.Request([], [], t0, time.perf_counter(), t,
                                         {}, chunk_s)
        f0 = time.perf_counter()
        with self.span("slambench.finish"):
            res = slam.finish(refine=True)
        t1 = time.perf_counter()
        return drive.Request([k], [drive.answer(res)], t0, t1, w.T,
                             res.timings, chunk_s, t1 - f0)

    def request(self, i):
        return self.session(i % len(self.worlds))

    def warm(self):
        # a whole session: the finish refines at the world's length
        self.session(0)
        self.sync()

    def traced(self):
        return self.session(0, int(self.traffic["trace"]["chunks"])).frames

    def reference(self, k, params, dtype=None):
        dtype = dtype or self.torch.float32
        return self.ref.streamed(self.worlds[k], params, self.device,
                                 dtype=dtype)

    def numbers(self, k, ans, whole, params):
        got = super().numbers(k, ans, whole, params)
        got.update(compare.steps(ans, self.ref.replay_stream(
            self.worlds[k], ans[0], params, self.device)))
        return got
