"""The reference against the port, through the harness's own run of each
cell at a tiny size on the CPU: a sound run is correct, and a run with the
timed path broken underneath is not (a token altered where it is
produced; a decode step that leaves its state unchanged)."""

import pytest
import torch

from portbench import run as run_lib, spec
from portbench.tests import tiny

SEED = 2**31 + 12345


def _cells():
    return {
        "qwen2-vl-7b.video-qa-1024f": (tiny.qwen_config(), tiny.video_qa(16)),
        "llava-video-7b.video-qa-384f": (tiny.llava_config(), tiny.video_qa(8)),
        "qwen2-vl-7b.serve-clips": (tiny.qwen_config(400), tiny.serve_clips()),
    }


# A closed loop's window holds as many requests as the host finishes in it;
# at 0 s it holds exactly one, so what the check compares does not depend on
# the load of the machine running the tests. (At these tiny shapes PivotKV
# keeps a few dozen tokens, and a near-tie at its keep boundary finer than
# bf16 resolves moves the logits by a tenth or more of their spread; at the
# cells' sizes such a flip is one token in thousands.)
SECONDS = {"closed": 0.0, "open": 1.0}


def _run(name):
    config, traffic = _cells()[name]
    limit = spec.cell(name)["limits"]["logit_err"]["limit"]
    torch.manual_seed(0)
    return run_lib.run_cell(tiny.cell(name, config, traffic, limit), SEED,
                            SECONDS[traffic["loop"]], False, "cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(_cells()))
def test_sound_run_is_correct(name):
    out = _run(name)
    gap = out["checks"]["logit_err"]
    assert out["correct"], gap
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert 0.0 <= gap["value"] <= gap["limit"]
    for m in spec.cell(name)["end_to_end"]:  # every one timed by the harness, and above 0
        assert out["metrics"][m["name"]]["value"] > 0, m["name"]


@pytest.mark.parametrize("mix", ["serve-bursts", "own-loop"])
def test_a_generator_file_drives_a_run(tmp_path, mix):
    """A mix given as a generator file alone drives a whole run at a tiny
    size: the bursty mix of ``test_portbench_spec`` through its own
    schedule on the serving path; a mix with a loop of its own."""
    from portbench.tests.test_portbench_spec import MIXES, _with_mix

    root, name, _ = _with_mix(tmp_path, mix)
    gen = spec.cell(name, root=root)["generator"]
    like = MIXES[mix][1]
    config, traffic = _cells()[like]
    traffic = dict(traffic, burst=3)
    cell = dict(tiny.cell(like, config, traffic, 1.0), generator=gen)
    out = run_lib.run_cell(cell, SEED, SECONDS[traffic["loop"]], False, "cpu")
    assert out["correct"] and out["failed"] == 0, out["checks"]
    if gen.loop is None:
        assert out["attempted"] == len(gen.schedule(traffic, SEED, 1.0)) == 3
    else:
        assert gen.loop[0].__globals__["DRIVEN"] == [SEED] and out["attempted"] >= 1


@pytest.mark.parametrize("name", list(_cells()))
def test_altered_token_is_caught(name, monkeypatch):
    from retake_tpu_torch.runtime import engine

    select = engine.select_tokens

    def altered(logits, sampler, stream, steps):
        tok = select(logits, sampler, stream, steps)
        return (tok + 1) % logits.shape[-1] if stream == engine.LOOP else tok

    monkeypatch.setattr(engine, "select_tokens", altered)
    out = _run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", list(_cells()))
def test_unchanged_decode_state_is_caught(name, monkeypatch):
    """A decode step that hands back the hidden state and the cache it was
    given: no layer runs, nothing is appended."""
    from retake_tpu_torch.models.qwen2_vl import text

    if "serve" in name:
        def unchanged(model, cfg, k_all, v_all, hidden, base_t, pos_rest, final_len, gap_start,
                      gap_filled, **kw):
            col = gap_start + gap_filled
            return hidden, k_all[:, :, :, col].clone(), v_all[:, :, :, col].clone()

        monkeypatch.setattr(text, "decode_step_batch", unchanged)
    else:
        chunk = text.decoder_chunk

        def unchanged(model, cfg, cache, hidden, *args, **kw):
            if hidden.shape[0] == 1:
                return hidden, cache
            return chunk(model, cfg, cache, hidden, *args, **kw)

        monkeypatch.setattr(text, "decoder_chunk", unchanged)
    out = _run(name)
    assert not out["correct"], out["checks"]
