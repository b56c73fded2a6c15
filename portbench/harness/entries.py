"""The entries a traffic mix can drive, by the name its file gives.

An entry wraps one mode instance of the port with its graph already
read: ``warm_up`` runs the cell's shapes once and keeps what the check
reads, ``call(seed)`` runs one job of the window under its own seed, and
``work`` is the nominal work of one call, the numerator of the cell's
rate.
"""
import torch


def reseed(mode, seed: int):
    """Give a built mode a new seed. The port pins its seed per instance
    on first use (``Base._seed``), and has no public way to reset it."""
    mode.random_state = int(seed)
    mode._resolved_seed = None


class WalksEntry:
    """``simulate_walks_device(num_walks, walk_length)``."""

    def __init__(self, mode, config, traffic):
        self.mode, self.config, self.traffic = mode, config, traffic
        self.num_walks, self.walk_length = config["num_walks"], config["walk_length"]
        self.last = None

    def work(self) -> float:
        return float(self.mode.num_nodes * self.num_walks * self.walk_length)

    def warm_up(self, seed: int):
        reseed(self.mode, seed)
        chunks = self.mode._walk_chunks(self.num_walks, self.walk_length)
        for _ in range(int(self.traffic["warmup"]["chunks"])):
            next(chunks)
        chunks.close()
        return {}

    def call(self, seed: int):
        reseed(self.mode, seed)
        self.last = self.mode.simulate_walks_device(self.num_walks, self.walk_length)
        return self.last

    def release(self):
        self.last = None


class EmbedEntry:
    """``embed(dim, num_walks, walk_length, window_size, epochs)`` with the
    defaults the CLI passes: streaming above 1e8 tokens, the trainer's
    auto table type."""

    def __init__(self, mode, config, traffic):
        self.mode, self.config, self.traffic = mode, config, traffic
        self.last = None

    def kwargs(self):
        c = self.config
        return dict(dim=c["dim"], num_walks=c["num_walks"], walk_length=c["walk_length"],
                    window_size=c["window_size"], epochs=c["epochs"],
                    table_dtype=c["table_dtype"])

    def work(self) -> float:
        c = self.config
        return float(self.mode.num_nodes * c["num_walks"] * (c["walk_length"] + 1))

    def warm_up(self, seed: int):
        """``embed(..., max_steps=k)``: the whole walk pass, the count pass
        and k chunk-steps. Keeps, on the host, every walk chunk, both
        tables before each chunk-step and after the last, and the
        embeddings ``embed`` returned: the check reads them."""
        from pecanpy_tpu_torch.models import sgns

        from harness.trace import patched

        steps = int(self.traffic["warmup"]["max_steps"])
        chunks, states = [], []
        walk_chunks, make_step_body = self.mode._walk_chunks, sgns.make_step_body

        def kept_chunks(num_walks, walk_length):
            for walks, eff in walk_chunks(num_walks, walk_length):
                chunks.append((walks.cpu(), eff.cpu()))
                yield walks, eff

        def kept_step_body(*args, **kwargs):
            step = make_step_body(*args, **kwargs)

            def kept(w_in, w_out, *rest):
                if not states:
                    states.append((w_in.to("cpu", copy=True), w_out.to("cpu", copy=True)))
                out = step(w_in, w_out, *rest)
                states.append((w_in.to("cpu", copy=True), w_out.to("cpu", copy=True)))
                return out

            return kept

        reseed(self.mode, seed)
        with patched([(self.mode, "_walk_chunks", kept_chunks),
                      (sgns, "make_step_body", kept_step_body)]):
            returned = self.mode.embed(**self.kwargs(), max_steps=steps)
        del self.mode._walk_chunks
        return dict(chunks=chunks, states=states, returned=returned, steps=steps)

    def call(self, seed: int):
        reseed(self.mode, seed)
        self.last = self.mode.embed(**self.kwargs())
        return self.last

    def release(self):
        self.last = None


ENTRIES = {"walks": WalksEntry, "embed": EmbedEntry}


def make(mode, config, traffic):
    return ENTRIES[traffic["entry"]](mode, config, traffic)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
