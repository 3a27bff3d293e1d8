"""v2 plotting (python/paddle/v2/plot/Ploter parity): cost curves during
training. Renders with matplotlib when available (and a display/backend
works); otherwise falls back to appending to an in-memory series that
can be dumped as CSV — the event-handler call sites work either way."""

__all__ = ["Ploter"]


class Ploter:
    def __init__(self, *titles):
        self.titles = list(titles)
        self.data = {t: ([], []) for t in titles}
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            self._plt = plt
        except Exception:
            self._plt = None

    def append(self, title, step, value):
        xs, ys = self.data[title]
        xs.append(step)
        ys.append(float(value))

    def plot(self, path=None):
        """Draw all series; saves to `path` (required under the Agg
        fallback — there is no interactive display in this environment)."""
        if self._plt is None:
            if path:
                self.save_csv(path + ".csv")
            return
        plt = self._plt
        plt.figure()
        for t in self.titles:
            xs, ys = self.data[t]
            plt.plot(xs, ys, label=t)
        plt.legend()
        if path:
            plt.savefig(path)
        plt.close()

    def save_csv(self, path):
        with open(path, "w") as f:
            for t in self.titles:
                xs, ys = self.data[t]
                for x, y in zip(xs, ys):
                    f.write("%s,%s,%s\n" % (t, x, y))

    def reset(self):
        self.data = {t: ([], []) for t in self.titles}
