"""Benchmark scorers: VideoMME, MLVU, LVBench + answer-letter extraction
(jax-free copy of ``retake_tpu/data/scorers.py``).

Output-compatible with the reference's evaluators (retake/dataset_utils.py:
231-420): identical DataFrame schemas (infer_results.csv / eval_results.csv)
and aggregation rules, so downstream tooling reads either framework's results.
The optional MLVU GPT-judge for generation tasks (Video Summary / Sub-Scene
Captioning) is behind ``enable_gpt_eval`` (off by default) and degrades to
exact-match scoring when the openai client is unavailable.
``tests/test_torch_eval.py`` pins this copy to the original.
"""

from __future__ import annotations

import json
import re
from typing import Dict

import pandas as pd


def trim_answer(s: str) -> str:
    """Extract the multiple-choice letter (reference trimm_results,
    infer_eval.py:25-46)."""
    s = s.strip()
    for prefix in (
        "The best answer is",
        "The correct answer is",
        "The answer is",
        "The answer",
        "The best option is",
        "The correct option is",
        "Best answer:",
        "Best option:",
    ):
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCDEFG]", s):
        return ""
    match = re.search(r"[ABCDEFG]", s)
    return match[0] if match else ""


def eval_videomme_results(anno_id2result: Dict, anno_id2meta: Dict, **kwargs):
    rows = []
    for anno_id, pred in anno_id2result.items():
        meta = anno_id2meta[anno_id]
        gt = meta["answer"]
        rows.append(
            dict(
                anno_id=anno_id,
                subfield=meta["task_type"],
                domain=meta["domain"],
                duration=meta["duration"],
                gt_answer=gt,
                pred_answer=pred,
                correct=int(gt.lower() == str(pred).lower()),
            )
        )
    infer_df = pd.DataFrame(rows)

    subfield_acc = infer_df.groupby("subfield")["correct"].mean()
    duration_acc = infer_df.groupby("duration")["correct"].mean()
    final = infer_df.groupby(["duration", "subfield"])["correct"].mean().unstack()
    final.loc["overall"] = subfield_acc
    # equal sample counts per duration => plain mean is the overall accuracy
    duration_acc.loc["overall"] = duration_acc.mean()
    final.insert(0, "overall", duration_acc)
    eval_df = final.reindex(["short", "medium", "long", "overall"]) * 100
    return eval_df, infer_df


MLVU_MC_TYPES = [
    "Topic Reasoning",
    "Anomaly Recognition",
    "Needle QA",
    "Ego Reasoning",
    "Plot QA",
    "Action Order",
    "Action Count",
]
MLVU_GEN_TYPES = ["Video Summary", "Sub-Scene Captioning"]
MLVU_DEV_ORDER = MLVU_MC_TYPES + ["M-AVG"] + MLVU_GEN_TYPES + ["G-AVG"]
# test split: the reference raises NotImplementedError for it but records
# the intended layout as "TR AR NQA ER PQA SQA AO AC TQA M-AVG SSC VS G-Avg"
# (reference dataset_utils.py:339-342, 357-366) — M-AVG runs over NINE MC
# types (SportsQA and Tutorial QA join the dev seven)
MLVU_TEST_MC_TYPES = [
    "Topic Reasoning",
    "Anomaly Recognition",
    "Needle QA",
    "Ego Reasoning",
    "Plot QA",
    "SportsQA",
    "Action Order",
    "Action Count",
    "Tutorial QA",
]
MLVU_TEST_ORDER = (
    MLVU_TEST_MC_TYPES
    + ["M-AVG", "Sub-Scene Captioning", "Video Summary", "G-AVG"]
)


def _mlvu_generation_score(anno_id, gt, pred, meta, enable_gpt_eval):
    """Exact match for MC; GPT-4 judge (3 retries, 0 on failure) for
    generation tasks when enabled (reference dataset_utils.py:101-228)."""
    if enable_gpt_eval and meta["question_type"] in MLVU_GEN_TYPES:
        try:
            import openai  # pragma: no cover - requires network

            client = openai.OpenAI()
            question = meta["question"].replace("<video>", "")
            pred = meta.get("original_answer", pred)
            for _ in range(3):
                try:
                    if meta["question_type"] == "Video Summary":
                        system = (
                            "Score the respondent's video summary 1-5 for "
                            "COMPLETENESS and 1-5 for RELIABILITY against the "
                            "standard answer. End with a JSON dict "
                            "{'score_completeness': c, 'score_reliability': r, "
                            "'total_score': c + r}."
                        )
                        user = (
                            f"Standard Answer: {gt}\nRespondent's Answer: {pred}"
                        )
                    else:
                        system = (
                            "Score the respondent's answer 1-5 for ACCURACY "
                            "against the scoring points and 1-5 for RELEVANCE "
                            "to the question. End with a JSON dict "
                            "{'score_accuracy': a, 'score_relevance': r, "
                            "'total_score': a + r}."
                        )
                        user = (
                            f"Question: {question}\nScoring Points: "
                            f"{meta.get('scoring_points')}\n"
                            f"Respondent's Answer: {pred}"
                        )
                    resp = client.chat.completions.create(
                        temperature=0,
                        model="gpt-4-turbo",
                        messages=[
                            {"role": "system", "content": system},
                            {"role": "user", "content": user},
                        ],
                    )
                    msg = resp.choices[0].message.content
                    m = re.search(r"```json\n(.*?)\n```", msg, re.DOTALL)
                    if m:
                        return json.loads(m.group(1))["total_score"], msg
                    return 0, msg
                except Exception:
                    continue
            return 0, ""
        except Exception:
            return 0, ""
    return int(gt.lower() == str(pred).lower()), ""


def eval_mlvu_results(anno_id2result: Dict, anno_id2meta: Dict, enable_gpt_eval=False):
    rows = []
    for anno_id, pred in anno_id2result.items():
        meta = anno_id2meta[anno_id]
        gt = meta["answer"]
        score, gpt_msg = _mlvu_generation_score(
            anno_id, gt, pred, meta, enable_gpt_eval
        )
        rows.append(
            dict(
                anno_id=anno_id,
                question_type=meta["question_type"],
                gt_answer=gt,
                pred_answer=pred,
                correct=score,
                gpt_message=gpt_msg,
            )
        )
    infer_df = pd.DataFrame(rows)

    # loud on unknown types: a silently-dropped sample corrupts M-AVG
    # (the reference raises NotImplementedError for the whole test split,
    # dataset_utils.py:339-342; we aggregate it instead — see
    # MLVU_TEST_MC_TYPES — but still refuse types we cannot place)
    types = set(infer_df["question_type"])
    unknown = types - set(MLVU_TEST_MC_TYPES) - set(MLVU_GEN_TYPES)
    if unknown:
        raise ValueError(
            f"unknown MLVU question types {sorted(unknown)}; known MC types "
            f"are {MLVU_TEST_MC_TYPES} and generation types {MLVU_GEN_TYPES}"
        )
    is_test = bool(types & {"SportsQA", "Tutorial QA"})
    mc_types = MLVU_TEST_MC_TYPES if is_test else MLVU_MC_TYPES
    order = MLVU_TEST_ORDER if is_test else MLVU_DEV_ORDER

    acc = infer_df.groupby("question_type")["correct"].mean() * 100
    acc = acc.reset_index().rename(columns={"correct": "Accuracy"})
    mc_rows = acc["question_type"].isin(mc_types)
    m_avg = acc[mc_rows]["Accuracy"].mean()
    g_rows = acc["question_type"].isin(MLVU_GEN_TYPES)
    # generation scores are 0-10 judge totals, not percentages
    acc.loc[g_rows, "Accuracy"] = acc.loc[g_rows, "Accuracy"] / 100
    g_avg = acc[g_rows]["Accuracy"].mean()
    overall = pd.DataFrame(
        {"question_type": ["M-AVG", "G-AVG"], "Accuracy": [m_avg, g_avg]}
    )
    eval_df = pd.concat([acc, overall], ignore_index=True)
    eval_df = eval_df.set_index("question_type").transpose()
    present = [c for c in order if c in eval_df.columns]
    return eval_df[present], infer_df


LVBENCH_ORDER = [
    "entity recognition",
    "event understanding",
    "key information retrieval",
    "temporal grounding",
    "reasoning",
    "summarization",
    "overall",
]


def eval_lvbench_results(anno_id2result: Dict, anno_id2meta: Dict, **kwargs):
    per_type: Dict[str, list] = {}
    rows = []
    for anno_id, pred in anno_id2result.items():
        meta = anno_id2meta[anno_id]
        gt = meta["answer"]
        correct = int(gt.lower() == str(pred).lower())
        rows.append(
            dict(
                anno_id=anno_id,
                question_type_list=json.dumps(meta["question_type"]),
                gt_answer=gt,
                pred_answer=pred,
                correct=correct,
            )
        )
        for qtype in list(meta["question_type"]) + ["overall"]:
            per_type.setdefault(qtype, []).append(correct)
    infer_df = pd.DataFrame(rows)
    eval_df = pd.DataFrame(
        {k: [sum(v) / len(v)] for k, v in per_type.items()}
    )
    eval_df = eval_df[[c for c in LVBENCH_ORDER if c in eval_df.columns]] * 100
    return eval_df, infer_df


def get_eval_methods(dataset_name: str):
    name = dataset_name.lower()
    if name == "videomme":
        return eval_videomme_results
    if name == "mlvu":
        return eval_mlvu_results
    if name == "lvbench":
        return eval_lvbench_results
    raise NotImplementedError(dataset_name)
